# Copied from extensions-builtin/forge_space_illusion_diffusion/forge_app.py (PAGE, center_crop, IllusionPipeline, process, the arguments).
"""The Illusion Diffusion Space: a pattern image (a QR code, a logo, text, a
spiral) conditions an SD1.5 ControlNet while the prompt paints over it.

One request is the reference app's two passes as one Processing: txt2img at
512² with "DPM++ SDE" Karras for 15 steps, the ControlNet at the illusion
strength within its guidance window, then the hires fix, a 2× "Latent
(nearest-exact)" upscale and 20 second-pass steps at `upscaler_strength`.
The ControlNet rides both passes: its hint, the pattern cropped to its short
side and resized to 512² by Pillow's LANCZOS (pipeline/images.py
`lanczos_resize`), is resized to each pass's size.

Run: python -m forge_tpu_torch.spaces.illusion_diffusion --host 127.0.0.1 --port 7871
     [--ckpt FILE] [--controlnet FILE] [--device cpu]

Both files are read once, before the port opens: --ckpt, by default
$ILLUSION_CKPT or models/checkpoints/illusion_sd15.safetensors, and
--controlnet, by default $ILLUSION_CONTROLNET or
models/ControlNet/qrmonster_sd15.safetensors; a control model that is not a
cldm ControlNet raises the reference's ValueError.
"""

import os

import numpy as np

from . import decode_upload, encode_answer

PAGE = """<!doctype html><html><head><title>Illusion Diffusion</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%}input[type=text]{width:100%}
label{display:block;margin:.4em 0}button{padding:.5em 1.5em}</style></head>
<body><h2>Illusion Diffusion</h2>
<label>Pattern image <input type=file id=f accept=image/*></label>
<label>Prompt <input type=text id=p value="a medieval village, winding roads"></label>
<label>Negative <input type=text id=n value="low quality, blurry"></label>
<label>Illusion strength <input type=range id=s min=0 max=2 step=0.05 value=1></label>
<label>Seed <input type=number id=seed value=-1></label>
<button onclick="go()">Generate</button>
<div><img id=out></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,prompt:document.getElementById('p').value,
   negative:document.getElementById('n').value,
   strength:parseFloat(document.getElementById('s').value),
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json();
 if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>"""


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Crop to the short side, then resize to size² (Pillow's LANCZOS)."""
    from ..pipeline.images import lanczos_resize

    h, w = img.shape[:2]
    s = min(h, w)
    top, left = (h - s) // 2, (w - s) // 2
    crop = img[top:top + s, left:left + s]
    return lanczos_resize(crop, size, size)


class IllusionPipeline:
    """Engine + ControlNet wired into the two-pass hires flow."""

    def __init__(self, engine, cn_params, cn_cfg):
        self.engine = engine
        self.cn_params = cn_params
        self.cn_cfg = cn_cfg

    @classmethod
    def from_files(cls, ckpt: str, controlnet: str, device=None):
        from ..extensions.controlnet import load_control_model
        from ..pipeline.engine import load_engine

        engine = load_engine(ckpt, device=device)
        kind, params, cfg, _ = load_control_model(controlnet, device=engine.device,
                                                  dtype=engine.compute_dtype)
        if kind != "controlnet":
            raise ValueError(f"{controlnet} is a {kind}, need a cldm ControlNet")
        return cls(engine, params, cfg)

    def run(self, pattern: np.ndarray, prompt: str, negative: str = "",
            strength: float = 1.0, guidance_scale: float = 8.0,
            guidance_start: float = 0.0, guidance_end: float = 1.0,
            upscaler_strength: float = 0.5, seed: int = -1,
            base_size: int = 512, steps: int = 15) -> np.ndarray:
        import torch

        from ..models.controlnet import ControlNetState
        from ..pipeline.processing import Processing, process_images

        hint = torch.from_numpy(np.ascontiguousarray(
            center_crop(pattern, base_size).transpose(2, 0, 1)[None]).astype(np.float32) / 255.0)
        p = Processing(
            prompt=prompt, negative_prompt=negative, seed=seed,
            steps=steps, width=base_size, height=base_size,
            cfg_scale=guidance_scale, sampler_name="DPM++ SDE",
            scheduler="karras",
            enable_hr=True, hr_scale=2.0,
            hr_upscaler="Latent (nearest-exact)",
            hr_second_pass_steps=20, hr_denoising_strength=upscaler_strength,
            do_not_save_samples=True, do_not_save_grid=True)
        p.controlnets = [ControlNetState(
            params=self.cn_params, hint=hint.to(self.engine.device), strength=strength,
            start_percent=guidance_start, end_percent=guidance_end, cfg=self.cn_cfg)]
        return process_images(self.engine, p).images[0]


def process(body, pipe):
    img = decode_upload(body["image"])
    out = pipe.run(
        img, body.get("prompt", ""), body.get("negative", ""),
        strength=float(body.get("strength", 1.0)),
        guidance_scale=float(body.get("guidance_scale", 8.0)),
        upscaler_strength=float(body.get("upscaler_strength", 0.5)),
        seed=int(body.get("seed", -1)))
    return {"image": encode_answer(out)}


def _setup(args):
    return IllusionPipeline.from_files(args.ckpt, args.controlnet, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("illusion space", PAGE, process, default_port=7871, args=[
        ("--ckpt", {"default": os.environ.get(
            "ILLUSION_CKPT", os.path.join(root, "models", "checkpoints",
                                          "illusion_sd15.safetensors"))}),
        ("--controlnet", {"default": os.environ.get(
            "ILLUSION_CONTROLNET", os.path.join(root, "models", "ControlNet",
                                                "qrmonster_sd15.safetensors"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
