# Copied from extensions-builtin/forge_space_idm_vton/forge_app.py (IdmVtonPipeline, default_mask, PAGE, process, the arguments).
"""The IDM-VTON Space: a person photo dressed in a garment photo.

A garment SDXL UNet runs on the clean cloth latent at each step and records
the hidden states every self-attention reads (the `attn1_context_patch`
hook, models/unet.py); the 13-channel try-on UNet (the noisy latent 4 +
mask 1 + masked person 4 + pose 4) joins them to its attn1 keys and values,
zeros in their place for the unconditional pass (tryon_pipeline.py:1793).
Each Euler step is one garment pass at batch 1 and the conditional and
unconditional try-on passes, each at batch 1; `calculate_input` scales the
noisy latent only, the conditioning channels ride unscaled. The try-on
region is an explicit mask or the torso box of `default_mask`; outside it
the person photo is composited back unchanged.

Both UNets run at the engine's SDXL geometry (heads of 64), where the
reference runs them at `UNetConfig()`'s default of 8 heads of any width
(shown from both sides in tests/test_torch_space_apps_sdxl.py). The start
noise is `np.random.default_rng(seed)`'s in the reference's NHWC order, the
σ the "normal" schedule's; the resizes are OpenCV's (preprocessors/cv2_np.py).

Checkpoint: one safetensors file with SDXL's keys, `model.diffusion_model.`
the try-on UNet, and the garment UNet under `garment_model.diffusion_model.`.

Run: python -m forge_tpu_torch.spaces.idm_vton --host H --port P [--ckpt FILE]
     [--device cpu]
"""

import os

import numpy as np
import torch

from . import decode_upload, encode_answer

GARMENT_PREFIX = "garment_model.diffusion_model."


class IdmVtonPipeline:
    def __init__(self, engine, garment_unet):
        self.engine = engine
        self.garment = garment_unet

    @classmethod
    def from_file(cls, path: str, device=None):
        from ..core.loader import to_device_tree
        from ..core.state_dict import filter_prefix, load_state_dict
        from ..pipeline.engine import load_engine

        sd = load_state_dict(path)
        garment_sd = filter_prefix(sd, GARMENT_PREFIX)
        engine = load_engine({k: v for k, v in sd.items() if not k.startswith(GARMENT_PREFIX)},
                             device=device)
        del sd
        return cls(engine, to_device_tree(garment_sd, engine.compute_dtype, engine.device))

    @torch.no_grad()
    def step(self, x, sigma, sigma_next, extra_ch, cloth_latent, cond, uncond, cloth_cond,
             cfg_scale: float) -> torch.Tensor:
        """One Euler step: the garment pass (capture), the cond and uncond try-on passes."""
        from ..models.unet import unet_apply

        eng = self.engine
        pred, cfg, dtype = eng.predictor, eng.unet_cfg, eng.compute_dtype
        sigma, sigma_next = np.float32(sigma), np.float32(sigma_next)
        t = torch.full((x.shape[0],), float(pred.timestep(sigma)), device=x.device)
        feats = []

        def capture(ctx_k, ctx_v, extra):
            feats.append(ctx_k)
            return ctx_k, ctx_v

        unet_apply(self.garment, cloth_latent.to(dtype), t, cloth_cond["context"],
                   y=cloth_cond.get("y"), cfg=cfg, hooks={"attn1_context_patch": (capture,)})

        def inject(zero):
            idx = {"i": 0}

            def fn(ctx_k, ctx_v, extra):
                f = feats[idx["i"]]
                idx["i"] += 1
                if zero:
                    f = torch.zeros_like(f)
                if f.shape[0] != ctx_k.shape[0]:
                    f = f.repeat(ctx_k.shape[0] // f.shape[0], 1, 1)
                f = f.to(ctx_k.dtype)
                return torch.cat([ctx_k, f], dim=1), torch.cat([ctx_v, f], dim=1)

            return fn

        # the scheduler's scaling on the noisy latent only; the conditioning channels ride
        # unscaled (the diffusers inpaint convention the reference pipeline follows)
        x_in = torch.cat([pred.calculate_input(sigma, x).to(x.dtype), extra_ch], dim=1).to(dtype)
        eps_c = unet_apply(eng.loaded.unet, x_in, t, cond["context"], y=cond.get("y"), cfg=cfg,
                           hooks={"attn1_context_patch": (inject(False),)}).float()
        eps_u = unet_apply(eng.loaded.unet, x_in, t, uncond["context"], y=uncond.get("y"),
                           cfg=cfg, hooks={"attn1_context_patch": (inject(True),)}).float()
        den_c = pred.calculate_denoised(sigma, eps_c, x)
        den_u = pred.calculate_denoised(sigma, eps_u, x)
        denoised = den_u + np.float32(cfg_scale) * (den_c - den_u)
        d = (x - denoised) / sigma
        return x + d * (sigma_next - sigma)

    @staticmethod
    def default_mask(h: int, w: int) -> np.ndarray:
        """The torso box where no mask is given (the reference derives the
        region from human parsing and OpenPose, src/tryon_pipeline.py; an
        explicit mask is the faithful input here)."""
        m = np.zeros((h, w), np.float32)
        m[int(0.18 * h):int(0.72 * h), int(0.22 * w):int(0.78 * w)] = 1.0
        return m

    def _latent(self, img: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)[None]).astype(np.float32))
        return self.engine.encode_first_stage(x / 127.5 - 1.0)

    @torch.no_grad()
    def run(self, person: np.ndarray, garment_img: np.ndarray,
            garment_desc: str = "clothes", mask: np.ndarray = None,
            pose: np.ndarray = None, steps: int = 20, cfg_scale: float = 2.0,
            seed: int = 0, width: int = 768, height: int = 1024) -> np.ndarray:
        from ..preprocessors import cv2_np
        from ..sampling.schedules import get_sigmas

        eng = self.engine
        h8, w8 = height // 8, width // 8

        person_r = cv2_np.resize(person, (width, height), cv2_np.INTER_AREA)
        garment_r = cv2_np.resize(garment_img, (width, height), cv2_np.INTER_AREA)
        if mask is None:
            mask = self.default_mask(height, width)
        else:
            mask = cv2_np.resize(mask.astype(np.float32), (width, height))
            if mask.max() > 1.5:
                mask = mask / 255.0

        person_lat = self._latent(person_r)
        masked = person_r.astype(np.float32) * (1.0 - mask[..., None])
        masked_lat = self._latent(masked.clip(0, 255).astype(np.uint8))
        cloth_lat = self._latent(garment_r)
        pose_lat = (self._latent(cv2_np.resize(pose, (width, height)))
                    if pose is not None else torch.zeros_like(person_lat))
        mask_lat = torch.from_numpy(cv2_np.resize(mask, (w8, h8), cv2_np.INTER_LINEAR)
                                    )[None, None].to(person_lat.device)
        extra_ch = torch.cat([mask_lat, masked_lat, pose_lat], dim=1)

        prompt = f"model is wearing {garment_desc}"
        cond = eng.get_learned_conditioning([prompt], width, height)
        uncond = eng.get_learned_conditioning(
            ["monochrome, lowres, bad anatomy, worst quality, low quality"],
            width, height, is_negative=True)
        cloth_cond = eng.get_learned_conditioning([f"a photo of {garment_desc}"], width, height)

        sigmas = get_sigmas("normal", int(steps), eng.predictor)
        rng = np.random.default_rng(seed)
        noise = rng.standard_normal((1, h8, w8, person_lat.shape[1])).astype(np.float32)
        x = torch.from_numpy(np.ascontiguousarray(noise.transpose(0, 3, 1, 2))).to(
            person_lat.device) * float(sigmas[0])
        for i in range(len(sigmas) - 1):
            x = self.step(x, sigmas[i], sigmas[i + 1], extra_ch, cloth_lat, cond, uncond,
                          cloth_cond, cfg_scale)

        img = eng.decode_first_stage(x)[0].cpu().numpy().transpose(1, 2, 0).astype(np.float32)
        img = ((img + 1.0) * 127.5).clip(0, 255).astype(np.uint8)
        # the untouched region composited back (the reference pastes the original person
        # outside the try-on mask)
        out = img * mask[..., None] + person_r * (1.0 - mask[..., None])
        out = out.clip(0, 255).astype(np.uint8)
        return cv2_np.resize(out, (person.shape[1], person.shape[0]), cv2_np.INTER_LINEAR)


PAGE = """<!doctype html><html><head><title>IDM-VTON</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:900px;
margin:2em auto}img{max-width:32%}button{padding:.5em 1.5em}
input[type=text]{width:60%}</style></head><body>
<h2>Virtual Try-On (IDM-VTON)</h2>
<p>person <input type=file id=person accept=image/*>
garment <input type=file id=garment accept=image/*>
mask (optional) <input type=file id=mask accept=image/*></p>
<input type=text id=desc value="short sleeve round neck t-shirt">
<label>steps <input type=number id=steps value=20 min=1 max=50></label>
<label>seed <input type=number id=seed value=0></label>
<button onclick="go()">Try on</button>
<div><img id=out></div>
<script>
async function b64(input){const f=input.files[0];if(!f)return null;
 const b=await f.arrayBuffer();
 return btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''))}
async function go(){
 const p=await b64(document.getElementById('person'));
 const g=await b64(document.getElementById('garment'));
 if(!p||!g)return alert('upload person and garment photos');
 const m=await b64(document.getElementById('mask'));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({person:p,garment:g,mask:m,
   desc:document.getElementById('desc').value,
   steps:parseInt(document.getElementById('steps').value),
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json(); if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>"""


def process(body, pipe):
    def dec(b64s, mode="RGB"):
        return decode_upload(b64s, mode) if b64s else None

    out = pipe.run(
        dec(body["person"]), dec(body["garment"]),
        garment_desc=body.get("desc", "clothes"),
        mask=dec(body.get("mask"), "L"),
        steps=int(body.get("steps", 20)),
        cfg_scale=float(body.get("cfg_scale", 2.0)),
        seed=int(body.get("seed", 0)),
        width=int(body.get("width", 768)),
        height=int(body.get("height", 1024)))
    return {"image": encode_answer(out)}


def _setup(args):
    return IdmVtonPipeline.from_file(args.ckpt, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("idm-vton space", PAGE, process, default_port=7875, args=[
        ("--ckpt", {"default": os.environ.get(
            "IDM_VTON_CKPT", os.path.join(root, "models", "idm_vton",
                                          "idm_vton.safetensors"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
