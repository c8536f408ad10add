# Copied from extensions-builtin/forge_space_iclight/forge_app.py (BG_SOURCES, gradient_bg, resize_and_center_crop, merge_iclight_unet, ICLightPipeline, PAGE, process, the arguments).
"""The IC-Light Space: text-conditioned relighting of a foreground.

At load, the SD1.5 UNet's stem conv is widened from 4 to the offset's 8
input channels (zeros in the new ones) and the iclight_sd15_fc offset is
added leaf by leaf in f32 (`merge_iclight_unet`; an offset in diffusers'
UNet keys is mapped by core/state_dict.py `diffusers_unet_to_ldm`). A
request composites the foreground onto neutral grey by the U²-Net mask
(models/u2net.py `U2NetMatter`), VAE-encodes it (the posterior's mean) and
hands that latent to every UNet step through the `x_concat` hook. The
low-res pass is txt2img, or img2img from a lighting-direction gradient at
round(steps / lowres_denoise) steps; its image is resized by Pillow's
LANCZOS to multiples of 64 and relit by an img2img second pass with the
foreground encoded again at that size, both with "DPM++ 2M SDE" Karras.

The matter is made as the reference makes it, in a `try` that leaves it None
where it cannot be built. Building it reads no file, as in the reference:
a --u2net-dir without weights answers each request with the matter's
RuntimeError, as the reference app's does.

Run: python -m forge_tpu_torch.spaces.iclight --host 127.0.0.1 --port 7873
     [--ckpt FILE] [--iclight FILE] [--u2net-dir DIR] [--device cpu]

Both files are read once, before the port opens: --ckpt, by default
$ICLIGHT_CKPT or models/checkpoints/realisticVision_v51.safetensors, and
--iclight, by default $ICLIGHT_OFFSET or
models/iclight/iclight_sd15_fc.safetensors; --u2net-dir is models/u2net
unless given.
"""

import os
from typing import Any, Mapping

import numpy as np

from . import decode_upload, encode_answer

BG_SOURCES = ("None", "Left Light", "Right Light", "Top Light", "Bottom Light")


def gradient_bg(source: str, width: int, height: int) -> "np.ndarray | None":
    """The lighting direction's initial background, or None."""
    if source in (None, "", "None"):
        return None
    if source == "Left Light":
        g = np.linspace(255, 0, width)[None, :]
    elif source == "Right Light":
        g = np.linspace(0, 255, width)[None, :]
    elif source == "Top Light":
        g = np.linspace(255, 0, height)[:, None]
    elif source == "Bottom Light":
        g = np.linspace(0, 255, height)[:, None]
    else:
        raise ValueError(f"unknown bg source {source!r}")
    img = np.broadcast_to(g, (height, width)).astype(np.uint8)
    return np.repeat(img[..., None], 3, axis=2)


def resize_and_center_crop(image: np.ndarray, tw: int, th: int) -> np.ndarray:
    """Pillow's LANCZOS to cover tw × th, then a centred crop whose float box
    is rounded as Pillow's `crop` rounds it (Python's round)."""
    from ..pipeline.images import lanczos_resize

    oh, ow = image.shape[:2]
    k = max(tw / ow, th / oh)
    rw, rh = int(round(ow * k)), int(round(oh * k))
    img = lanczos_resize(image, rw, rh)
    left, top = (rw - tw) / 2, (rh - th) / 2
    x0, y0, x1, y1 = (int(round(v)) for v in (left, top, left + tw, top + th))
    return np.ascontiguousarray(img[y0:y1, x0:x1])


def merge_iclight_unet(unet_tree: Mapping[str, Any], offset_sd: Mapping[str, Any]):
    """Widen the stem conv to the offset's input width (zeros in the new
    channels: axis 1 of OIHW) and add the offset leaf by leaf in f32, cast
    back to the base's dtype and layout."""
    import torch

    from ..core.convert import nest, to_tensor
    from ..core.state_dict import diffusers_unet_to_ldm

    if any(k.startswith("down_blocks.") for k in offset_sd):
        offset_sd = diffusers_unet_to_ldm(offset_sd)
    off = nest(dict(offset_sd))

    def walk(base, delta):
        if isinstance(delta, Mapping):
            out = dict(base)
            for k, v in delta.items():
                out[k] = walk(base[k], v)
            return out
        b, d = base, to_tensor(delta).to(base.device)
        if b.dim() == 4 and d.dim() == 4 and d.shape[1] > b.shape[1]:
            pad = b.new_zeros((b.shape[0], d.shape[1] - b.shape[1]) + tuple(b.shape[2:]))
            b = torch.cat([b, pad], dim=1)  # OIHW: widen input channels
        out = torch.empty_like(b)  # the base's dtype and memory format
        out.copy_(b.float() + d.float())
        return out

    return walk(unet_tree, off)


class ICLightPipeline:
    def __init__(self, engine, matter=None):
        self.engine = engine
        self.matter = matter  # U2NetMatter or None (a pre-cut foreground)

    @classmethod
    def from_files(cls, ckpt: str, iclight: str, u2net_dir: str = "", device=None):
        from ..core.state_dict import load_state_dict
        from ..pipeline.engine import load_engine

        engine = load_engine(ckpt, device=device)
        engine.loaded.unet = merge_iclight_unet(engine.loaded.unet, load_state_dict(iclight))
        matter = None
        if u2net_dir:
            try:
                from ..models.u2net import U2NetMatter

                matter = U2NetMatter(model_dir=u2net_dir, device=engine.device)
            except Exception:  # noqa: BLE001 — the reference's: the matter is optional
                matter = None
        return cls(engine, matter)

    def _fg_latent(self, fg: np.ndarray, w: int, h: int):
        import torch

        fg = resize_and_center_crop(fg, w, h)
        x = torch.from_numpy(np.ascontiguousarray(
            fg.transpose(2, 0, 1)[None]).astype(np.float32) / 127.0 - 1.0)
        return self.engine.encode_first_stage(x)  # the posterior's mean

    def _hooks(self, fg_latent):
        # x_concat: the UNet tiles the latent to x's batch and resizes it to x's size
        return {"x_concat": (lambda x: fg_latent,)}

    def run(self, input_fg: np.ndarray, prompt: str,
            a_prompt: str = "best quality", n_prompt: str = "lowres, bad "
            "anatomy, bad hands, cropped, worst quality",
            width: int = 512, height: int = 512, seed: int = -1,
            steps: int = 25, cfg: float = 2.0, bg_source: str = "None",
            lowres_denoise: float = 0.9, highres_scale: float = 1.5,
            highres_denoise: float = 0.5) -> np.ndarray:
        from ..pipeline.images import lanczos_resize
        from ..pipeline.processing import Processing, process_images

        if self.matter is not None:
            # the subject alpha-composited onto neutral grey, so the model sees only its
            # own shading
            alpha = self.matter.mask(input_fg)[..., None]
            input_fg = np.clip(
                127 + (input_fg.astype(np.float32) - 127) * alpha,
                0, 255).astype(np.uint8)
        full = prompt + ", " + a_prompt if a_prompt else prompt

        p = Processing(prompt=full, negative_prompt=n_prompt, seed=seed,
                       steps=steps, width=width, height=height,
                       cfg_scale=cfg, sampler_name="DPM++ 2M SDE",
                       scheduler="karras", do_not_save_samples=True,
                       do_not_save_grid=True)
        bg = gradient_bg(bg_source, width, height)
        if bg is not None:
            p.init_images = [bg]
            p.denoising_strength = lowres_denoise
            p.steps = int(round(steps / lowres_denoise))
        p.unet_hooks = self._hooks(self._fg_latent(input_fg, width, height))
        low = process_images(self.engine, p).images[0]

        # pixel upscale → img2img second pass with a re-encoded foreground latent
        nw = int(round(width * highres_scale / 64.0) * 64)
        nh = int(round(height * highres_scale / 64.0) * 64)
        up = lanczos_resize(low, nw, nh)
        p2 = Processing(prompt=full, negative_prompt=n_prompt, seed=seed,
                        steps=max(int(round(steps / highres_denoise)), 1),
                        width=nw, height=nh, cfg_scale=cfg,
                        sampler_name="DPM++ 2M SDE", scheduler="karras",
                        init_images=[up], denoising_strength=highres_denoise,
                        do_not_save_samples=True, do_not_save_grid=True)
        p2.unet_hooks = self._hooks(self._fg_latent(input_fg, nw, nh))
        return process_images(self.engine, p2).images[0]


PAGE = """<!doctype html><html><head><title>IC-Light</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%}input[type=text]{width:100%}
label{display:block;margin:.4em 0}button{padding:.5em 1.5em}</style></head>
<body><h2>IC-Light relighting</h2>
<label>Foreground image <input type=file id=f accept=image/*></label>
<label>Prompt <input type=text id=p value="beautiful woman, cinematic lighting"></label>
<label>Lighting <select id=bg>%BG%</select>
Seed <input type=number id=seed value=12345></label>
<button onclick="go()">Relight</button>
<div><img id=out></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,prompt:document.getElementById('p').value,
   bg_source:document.getElementById('bg').value,
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json();
 if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>""".replace(
    "%BG%", "".join(f"<option>{b}</option>" for b in BG_SOURCES))


def process(body, pipe):
    img = decode_upload(body["image"])
    out = pipe.run(img, body.get("prompt", ""),
                   seed=int(body.get("seed", 12345)),
                   bg_source=body.get("bg_source", "None"))
    return {"image": encode_answer(out)}


def _setup(args):
    return ICLightPipeline.from_files(args.ckpt, args.iclight, args.u2net_dir, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("iclight space", PAGE, process, default_port=7873, args=[
        ("--ckpt", {"default": os.environ.get(
            "ICLIGHT_CKPT", os.path.join(root, "models", "checkpoints",
                                         "realisticVision_v51.safetensors"))}),
        ("--iclight", {"default": os.environ.get(
            "ICLIGHT_OFFSET", os.path.join(root, "models", "iclight",
                                           "iclight_sd15_fc.safetensors"))}),
        ("--u2net-dir", {"default": os.path.join(root, "models", "u2net")}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
