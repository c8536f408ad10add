# Copied from extensions-builtin/forge_space_geowizard/forge_app.py (LATENT_SCALE, DOMAINS, GeoWizardPipeline, PAGE, process, the arguments).
"""The GeoWizard Space: joint depth and surface-normal estimation by a
modified SD UNet that denoises a geometry latent beside the image's latent
(an 8-channel input), under a CLIP image embedding as its one-token
cross-attention context and a 10-wide "domain switcher" class embedding
through its `label_emb` (geowizard_pipeline.py:258-270).

The UNet runs at the reference's default geometry (models/unet.py
`UNetConfig()`: 8 heads, context 768), which is SD1's: its self-attention
goes through the flash kernel and its ResBlocks through the fused
GroupNorm+SiLU+conv3x3 kernel on the card, as the VAE's do. The DDIM loop is
a host loop where the reference runs `lax.scan`, with the same arithmetic:
`make_beta_schedule(1000)`'s ᾱ, the timesteps JAX's float32
`linspace(999, 0, steps)` rounds to, ᾱ_prev = 1 at the last step. The
CLIP-vision feed is ops/resize.py's bilinear resize to 224² with antialias
(`jax.image.resize`'s default); the image latent is `vae_encode`'s mean
×0.18215. The image goes to multiples of 64 by OpenCV's INTER_AREA and the
maps back by INTER_LINEAR on float32 (preprocessors/cv2_np.py), the start
noise is `np.random.default_rng(seed)`'s in the reference's NHWC order.

Checkpoint: one safetensors file with `unet.` (ldm keys, or diffusers'
mapped by core/state_dict.py `diffusers_unet_to_ldm`), `vae.` and
`image_encoder.` (CLIP vision, HF keys) prefixes; the weights in bf16 on
the card, f32 on the CPU.

Run: python -m forge_tpu_torch.spaces.geowizard --host H --port P [--ckpt FILE]
     [--device cpu]
"""

import os

import numpy as np
import torch

from . import decode_upload, encode_answer

LATENT_SCALE = 0.18215
DOMAINS = {"indoor": [1.0, 0.0, 0.0], "outdoor": [0.0, 1.0, 0.0],
           "object": [0.0, 0.0, 1.0]}
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def ddim_timesteps(steps: int) -> np.ndarray:
    """`jnp.linspace(999.0, 0.0, steps).round()` as JAX computes it in float32:
    999·(1 − i·(1/(steps − 1))), the last one 0, rounded half to even (equal to
    JAX's for every count below 355; the page takes 1–50)."""
    if steps == 1:
        return np.asarray([999], np.int64)
    frac = np.arange(steps - 1, dtype=np.float32) * (np.float32(1.0) / np.float32(steps - 1))
    ts = np.concatenate([np.float32(999.0) * (np.float32(1.0) - frac), [np.float32(0.0)]])
    return np.round(ts.astype(np.float32)).astype(np.int64)


class GeoWizardPipeline:
    def __init__(self, unet, vae, clipvision):
        self.unet = unet
        self.vae = vae
        self.clipvision = clipvision

    @classmethod
    def from_file(cls, path: str, device=None, dtype=None):
        from ..core.device import placement
        from ..core.loader import to_device_tree
        from ..core.state_dict import diffusers_unet_to_ldm, filter_prefix, load_state_dict

        device, dtype = placement(device, dtype, torch.bfloat16)
        sd = load_state_dict(path)
        unet_sd = filter_prefix(sd, "unet.")
        if any(k.startswith("down_blocks.") for k in unet_sd):
            unet_sd = diffusers_unet_to_ldm(unet_sd)
        return cls(*(to_device_tree(part, dtype, device)
                     for part in (unet_sd, filter_prefix(sd, "vae."), filter_prefix(sd, "image_encoder."))))

    @staticmethod
    def _class_embedding(domain: str) -> torch.Tensor:
        """[2, 10] f32, rows [depth, normal]: sin and cos of the 2-d geometry
        one-hot, then of the 3-d domain one-hot."""
        geo = np.asarray([[0.0, 1.0], [1.0, 0.0]])
        dom = np.repeat(np.asarray(DOMAINS[domain])[None], 2, axis=0)
        return torch.from_numpy(np.concatenate(  # rounded once from float64, as XLA's sin
            [np.sin(geo), np.cos(geo), np.sin(dom), np.cos(dom)], axis=-1).astype(np.float32))

    @torch.no_grad()
    def infer(self, rgb: torch.Tensor, noise: torch.Tensor, class_emb: torch.Tensor,
              steps: int, trace=None):
        """rgb [1,3,H,W] in [-1,1], noise [2,4,h,w] f32 → (depth [H,W], normal
        [3,H,W]) f32. `trace`, a list, gets each step's geometry latent."""
        from ..models.clipvision import clip_vision_apply
        from ..models.unet import UNetConfig, unet_apply
        from ..models.vae import vae_decode, vae_encode
        from ..ops.resize import resize
        from ..sampling.prediction import make_beta_schedule

        device = rgb.device
        dtype = self.unet["time_embed"]["0"]["weight"].dtype
        # the CLIP image embedding as the one-token cross-attention context
        # (geowizard_pipeline.py:226: image_embeds.unsqueeze(1))
        feed = resize(rgb.float(), (224, 224), "bilinear", antialias=True)
        mean = torch.tensor(CLIP_MEAN, device=device).reshape(1, 3, 1, 1)
        std = torch.tensor(CLIP_STD, device=device).reshape(1, 3, 1, 1)
        feed = ((feed + 1.0) / 2.0 - mean) / std
        img_embed, _, _ = clip_vision_apply(self.clipvision, feed)
        context = img_embed[:, None, :].expand(2, 1, img_embed.shape[-1]).to(dtype)

        rgb_latent = vae_encode(self.vae, rgb.to(dtype)).float() * LATENT_SCALE
        rgb_latent = torch.cat([rgb_latent, rgb_latent], dim=0)
        geo = noise.float()
        y = class_emb.to(device, dtype)
        alphas = torch.from_numpy(np.cumprod(1.0 - make_beta_schedule(1000), axis=0)
                                  .astype(np.float32)).to(device)
        ts = ddim_timesteps(int(steps)).tolist()
        for i, t in enumerate(ts):
            a_t = alphas[t]
            a_prev = alphas[ts[i + 1]] if i + 1 < len(ts) else torch.ones((), device=device)
            x_in = torch.cat([rgb_latent, geo], dim=1).to(dtype)
            eps = unet_apply(self.unet, x_in, torch.full((2,), float(t), device=device),
                             context, y=y, cfg=UNetConfig()).float()
            x0 = (geo - (1.0 - a_t).sqrt() * eps) / a_t.sqrt()
            geo = a_prev.sqrt() * x0 + (1.0 - a_prev).sqrt() * eps
            if trace is not None:
                trace.append(geo)

        decoded = vae_decode(self.vae, (geo / LATENT_SCALE).to(dtype)).float()  # [2, 3, H, W]
        depth = decoded[0].mean(dim=0).clamp(-1.0, 1.0)
        depth = (depth + 1.0) / 2.0
        lo, hi = depth.min(), depth.max()
        depth = (depth - lo) / torch.clamp(hi - lo, min=1e-6)
        normal = decoded[1].clamp(-1.0, 1.0)
        normal = normal / torch.linalg.vector_norm(normal, dim=0, keepdim=True).clamp(min=1e-5)
        return depth, normal

    def run(self, img: np.ndarray, domain: str = "indoor",
            denoise_steps: int = 10, seed: int = 0,
            processing_res: int = 768):
        """uint8 [H,W,3] → (depth_vis uint8 [H,W], normal_vis uint8 [H,W,3])."""
        from ..preprocessors import cv2_np

        h, w = img.shape[:2]
        scale = processing_res / max(h, w)
        # a latent-friendly working size (multiples of 64, as the reference's resize_max_res)
        nh = max(64, int(round(h * scale / 64)) * 64)
        nw = max(64, int(round(w * scale / 64)) * 64)
        feed = cv2_np.resize(img, (nw, nh), cv2_np.INTER_AREA)
        device = self.unet["time_embed"]["0"]["weight"].device
        rgb = torch.from_numpy(np.ascontiguousarray(
            feed.transpose(2, 0, 1)[None]).astype(np.float32)).to(device) / 127.5 - 1.0

        rng = np.random.default_rng(seed)
        noise = rng.standard_normal((2, nh // 8, nw // 8, 4)).astype(np.float32)
        noise = torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))).to(device)
        depth, normal = self.infer(rgb, noise, self._class_embedding(domain), int(denoise_steps))
        depth = cv2_np.resize(depth.cpu().numpy().astype(np.float32), (w, h),
                              cv2_np.INTER_LINEAR)
        normal = cv2_np.resize(np.ascontiguousarray(
            normal.cpu().numpy().transpose(1, 2, 0).astype(np.float32)), (w, h),
            cv2_np.INTER_LINEAR)
        # resampling averages unit vectors: renormalise after the resize
        normal /= np.maximum(np.linalg.norm(normal, axis=-1, keepdims=True), 1e-5)
        # the reference's visualisation: depth as inverted grey, normals mapped to [0, 255]
        depth_vis = ((1.0 - depth) * 255.0).clip(0, 255).astype(np.uint8)
        normal_vis = ((normal + 1.0) / 2.0 * 255.0).clip(0, 255).astype(np.uint8)
        return depth_vis, normal_vis


PAGE = """<!doctype html><html><head><title>GeoWizard</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:900px;
margin:2em auto}img{max-width:49%}button{padding:.5em 1.5em}</style>
</head><body>
<h2>GeoWizard — depth &amp; normal estimation</h2>
<input type=file id=f accept=image/*>
<select id=domain><option>indoor</option><option>outdoor</option>
<option>object</option></select>
<label>steps <input type=number id=steps value=10 min=1 max=50></label>
<label>seed <input type=number id=seed value=0></label>
<button onclick="go()">Run</button>
<div><img id=depth><img id=normal></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,domain:document.getElementById('domain').value,
   steps:parseInt(document.getElementById('steps').value),
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json(); if(j.error){alert(j.error);return}
 document.getElementById('depth').src='data:image/png;base64,'+j.depth;
 document.getElementById('normal').src='data:image/png;base64,'+j.normal;
}
</script></body></html>"""


def process(body, pipe):
    img = decode_upload(body["image"])
    depth, normal = pipe.run(
        img, domain=body.get("domain", "indoor"),
        denoise_steps=int(body.get("steps", 10)),
        seed=int(body.get("seed", 0)),
        processing_res=int(body.get("processing_res", 768)))
    return {"depth": encode_answer(depth), "normal": encode_answer(normal)}


def _setup(args):
    return GeoWizardPipeline.from_file(args.ckpt, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("geowizard space", PAGE, process, default_port=7874, args=[
        ("--ckpt", {"default": os.environ.get(
            "GEOWIZARD_CKPT", os.path.join(root, "models", "geowizard",
                                           "geowizard.safetensors"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
