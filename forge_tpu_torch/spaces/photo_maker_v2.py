# Copied from extensions-builtin/forge_space_photo_maker_v2/forge_app.py (STYLES, ASPECTS, apply_style, PAGE, process, the arguments).
"""The PhotoMaker V2 Space: face photos and a prompt holding the trigger
word "img" in, an identity-preserving SDXL generation out. The stacked-ID
conditioning is pipeline/photomaker.py's; the styles and aspect ratios are
the reference app's tables.

Run: python -m forge_tpu_torch.spaces.photo_maker_v2 --host H --port P
     [--ckpt SDXL] [--photomaker FILE] [--device cpu]

Both files are read once, before the port opens: --ckpt, by default
$PHOTOMAKER_SDXL_CKPT or models/checkpoints/realvisxl-v4.safetensors, and
--photomaker, by default $PHOTOMAKER_CKPT or
models/photomaker/photomaker-v2.safetensors. A body's `face_embeds` (a
512-wide face embedding a photo, or one list) feed the v2 qformer.
"""

import json
import os

import numpy as np

from . import decode_upload, encode_answer

# Style prompt templates (reference style_template.py — published prompt
# strings, the app's UX surface). {prompt} is the user text.
STYLES = {
    "(No style)": ("{prompt}", ""),
    "Photographic (Default)": (
        "cinematic photo {prompt}. 35mm photograph, film, bokeh, professional, 4k, highly detailed",
        "drawing, painting, crayon, sketch, graphite, impressionist, noisy, blurry, soft, deformed, ugly"),
    "Cinematic": (
        "cinematic still {prompt}. emotional, harmonious, vignette, highly detailed, high budget, bokeh, "
        "cinemascope, moody, epic, gorgeous, film grain, grainy",
        "anime, cartoon, graphic, text, painting, crayon, graphite, abstract, glitch, deformed, mutated, ugly, disfigured"),
    "Disney Character": (
        "A Pixar animation character of {prompt}. pixar-style, studio anime, Disney, high-quality",
        "lowres, bad anatomy, bad hands, text, bad eyes, bad arms, bad legs, error, missing fingers, "
        "cropped, worst quality, low quality, ugly, duplicate, trademark, watermark, grainy"),
    "Digital Art": (
        "concept art {prompt}. digital artwork, illustrative, painterly, matte painting, highly detailed",
        "photo, photorealistic, realism, ugly"),
    "Fantasy art": (
        "ethereal fantasy concept art of {prompt}. magnificent, celestial, ethereal, painterly, epic, "
        "majestic, magical, fantasy art, cover art, dreamy",
        "photographic, realistic, realism, 35mm film, dslr, cropped, frame, text, deformed, glitch, noise, "
        "noisy, off-center, deformed, cross-eyed, closed eyes, bad anatomy, ugly, disfigured, sloppy, "
        "duplicate, mutated, black and white"),
    "Neonpunk": (
        "neonpunk style {prompt}. cyberpunk, vaporwave, neon, vibes, vibrant, stunningly beautiful, crisp, "
        "detailed, sleek, ultramodern, magenta highlights, dark purple shadows, high contrast, cinematic, "
        "ultra detailed, intricate, professional",
        "painting, drawing, illustration, glitch, deformed, mutated, cross-eyed, ugly, disfigured"),
    "Comic book": (
        "comic {prompt}. graphic illustration, comic art, graphic novel art, vibrant, highly detailed",
        "photograph, deformed, glitch, noisy, realistic, stock photo"),
}

ASPECTS = {
    "1024 x 1024 (Square)": (1024, 1024),
    "832 x 1216 (Portrait)": (832, 1216),
    "1216 x 832 (Landscape)": (1216, 832),
    "896 x 1152": (896, 1152),
    "1152 x 896": (1152, 896),
}


def apply_style(name, prompt, negative):
    tpl, neg = STYLES.get(name, STYLES["(No style)"])
    return tpl.replace("{prompt}", prompt), (neg + " " + negative).strip()

class PhotoMakerPipeline:
    def __init__(self, engine, pm_params):
        self.engine = engine
        self.pm = pm_params

    @classmethod
    def from_files(cls, ckpt: str, photomaker: str, device=None):
        from ..pipeline.engine import load_engine
        from ..pipeline.photomaker import load_photomaker

        engine = load_engine(ckpt, device=device)
        return cls(engine, load_photomaker(photomaker, device=engine.device,
                                           dtype=engine.compute_dtype))

    def run(self, id_images, prompt, negative="", style="Photographic (Default)",
            steps=30, guidance_scale=5.0, seed=-1, aspect="1024 x 1024 (Square)",
            style_strength_ratio=20.0, width=None, height=None,
            face_embeds=None) -> np.ndarray:
        from ..pipeline.photomaker import build_cond_transform
        from ..pipeline.processing import Processing, process_images

        styled, styled_neg = apply_style(style, prompt, negative)
        w, h = ASPECTS.get(aspect, (1024, 1024))
        if width and height:
            w, h = width, height
        transform = build_cond_transform(
            self.engine, self.pm, styled, id_images=id_images,
            face_embeds=face_embeds,
            start_merge_ratio=float(style_strength_ratio) / 100.0)
        p = Processing(
            prompt=styled, negative_prompt=styled_neg, seed=seed, steps=steps,
            width=w, height=h, cfg_scale=guidance_scale, sampler_name="Euler",
            cond_transform=transform,
            do_not_save_samples=True, do_not_save_grid=True)
        return process_images(self.engine, p).images[0]


PAGE = """<!doctype html><html><head><title>PhotoMaker V2</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%}input[type=text]{width:100%}
button{padding:.5em 1.5em}</style></head><body>
<h2>PhotoMaker V2 — identity-preserving generation</h2>
<p>1. Upload face photos. 2. Prompt must contain the trigger word
<b>img</b> (e.g. "a photo of a man img").</p>
<input type=file id=f accept=image/* multiple>
<input type=text id=prompt value="a photo of a person img">
<select id=style></select>
<select id=aspect></select>
<label>seed <input type=number id=seed value=-1></label>
<button onclick="go()">Generate</button>
<div><img id=out></div>
<script>
const STYLES=%STYLES%;const ASPECTS=%ASPECTS%;
for(const s of STYLES){const o=document.createElement('option');o.text=s;
 document.getElementById('style').add(o)}
for(const a of ASPECTS){const o=document.createElement('option');o.text=a;
 document.getElementById('aspect').add(o)}
async function go(){
 const files=document.getElementById('f').files; if(!files.length)return alert('upload a face photo');
 const imgs=[];
 for(const f of files){const b=await f.arrayBuffer();
  imgs.push(btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),'')))}
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({images:imgs,prompt:document.getElementById('prompt').value,
   style:document.getElementById('style').value,
   aspect:document.getElementById('aspect').value,
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json(); if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>"""
PAGE = PAGE.replace("%STYLES%", json.dumps(list(STYLES))) \
           .replace("%ASPECTS%", json.dumps(list(ASPECTS)))


def process(body, pipe):
    imgs = [decode_upload(b) for b in body.get("images", [])]
    out = pipe.run(
        imgs, body.get("prompt", ""),
        negative=body.get("negative", ""),
        style=body.get("style", "Photographic (Default)"),
        aspect=body.get("aspect", "1024 x 1024 (Square)"),
        steps=int(body.get("steps", 30)),
        guidance_scale=float(body.get("guidance_scale", 5.0)),
        seed=int(body.get("seed", -1)),
        width=body.get("width"), height=body.get("height"),
        face_embeds=body.get("face_embeds"))
    return {"image": encode_answer(out)}


def _setup(args):
    return PhotoMakerPipeline.from_files(args.ckpt, args.photomaker, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("photomaker space", PAGE, process, default_port=7873, args=[
        ("--ckpt", {"default": os.environ.get(
            "PHOTOMAKER_SDXL_CKPT", os.path.join(root, "models", "checkpoints",
                                                 "realvisxl-v4.safetensors"))}),
        ("--photomaker", {"default": os.environ.get(
            "PHOTOMAKER_CKPT", os.path.join(root, "models", "photomaker",
                                            "photomaker-v2.safetensors"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
