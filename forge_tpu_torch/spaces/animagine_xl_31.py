# Copied from extensions-builtin/forge_space_animagine_xl_31/forge_app.py (QUALITY_TAGS, STYLES, ASPECT_RATIOS, apply_preset, pick_size, PAGE, process, the arguments).
"""The Animagine XL 3.1 Space: an anime-model prompt helper over an SDXL
checkpoint. Quality-tag and style presets are merged into the prompt, an
aspect-ratio preset sets the size, and the optional upscale is the hires
fix at "Latent (nearest-exact)" (the public app's img2img second pass at
`upscaler_strength`).

Run: python -m forge_tpu_torch.spaces.animagine_xl_31 --host 127.0.0.1 --port 7872
     [--ckpt FILE] [--device cpu]

The checkpoint is read once, before the port opens: --ckpt, by default
$ANIMAGINE_CKPT or models/checkpoints/animagine-xl-3.1.safetensors.
"""

import os

import numpy as np

from . import encode_answer

QUALITY_TAGS = {
    "(None)": ("{prompt}", ""),
    "Standard v3.1": (
        "{prompt}, masterpiece, best quality, very aesthetic, absurdres",
        "lowres, (bad), text, error, fewer, extra, missing, worst quality, "
        "jpeg artifacts, low quality, watermark, unfinished, displeasing, "
        "oldest, early, chromatic aberration, signature, extra digits, "
        "artistic error, username, scan, [abstract]"),
    "Standard v3.0": (
        "{prompt}, masterpiece, best quality",
        "lowres, bad anatomy, bad hands, text, error, missing fingers, "
        "extra digit, fewer digits, cropped, worst quality, low quality, "
        "normal quality, jpeg artifacts, signature, watermark, username, "
        "blurry"),
    "Light v3.1": ("{prompt}, (masterpiece), best quality, very aesthetic",
                   "(low quality, worst quality:1.2), very displeasing, "
                   "3d, watermark, signature, ugly, poorly drawn"),
}

STYLES = {
    "(None)": ("{prompt}", ""),
    "Cinematic": (
        "{prompt}, cinematic still, emotional, harmonious, vignette, highly "
        "detailed, high budget, bokeh, cinemascope, moody, epic, gorgeous, "
        "film grain, grainy",
        "cartoon, graphic, text, painting, crayon, graphite, abstract, "
        "glitch, deformed, mutated, ugly, disfigured"),
    "Photographic": (
        "{prompt}, cinematic photo, 35mm photograph, film, bokeh, "
        "professional, 4k, highly detailed",
        "drawing, painting, crayon, sketch, graphite, impressionist, noisy, "
        "blurry, soft, deformed, ugly"),
    "Anime": (
        "{prompt}, anime artwork, anime style, vibrant, studio anime, "
        "highly detailed",
        "photo, deformed, black and white, realism, disfigured, low contrast"),
    "Manga": (
        "{prompt}, manga style, vibrant, high-energy, detailed, iconic, "
        "Japanese comic style",
        "ugly, deformed, noisy, blurry, low contrast, realism, "
        "photorealistic, Western comic style"),
    "Digital Art": ("{prompt}, concept art, digital artwork, illustrative, "
                    "painterly, matte painting, highly detailed",
                    "photo, photorealistic, realism, ugly"),
    "Pixel art": ("{prompt}, pixel-art, low-res, blocky, pixel art style, "
                  "8-bit graphics",
                  "sloppy, messy, blurry, noisy, highly detailed, "
                  "ultra textured, photo, realistic"),
}

ASPECT_RATIOS = ["1024 x 1024", "1152 x 896", "896 x 1152", "1216 x 832",
                 "832 x 1216", "1344 x 768", "768 x 1344", "1536 x 640",
                 "640 x 1536", "Custom"]


def apply_preset(table, name, prompt, negative):
    """Reference utils.preprocess_prompt: fill {prompt} into the preset
    positive, append preset negative."""
    pos_t, neg_t = table.get(name, table["(None)"])
    pos = pos_t.format(prompt=prompt)
    neg = (neg_t + ", " + negative).strip(", ") if negative else neg_t
    return pos, neg


def pick_size(aspect: str, custom_w: int, custom_h: int):
    if aspect in ASPECT_RATIOS and aspect != "Custom":
        w, h = (int(x) for x in aspect.split(" x "))
        return w, h
    # reference utils.preprocess_image_dimensions: multiples of 8
    return max(custom_w // 8, 1) * 8, max(custom_h // 8, 1) * 8

class AnimaginePipeline:
    def __init__(self, engine):
        self.engine = engine

    @classmethod
    def from_file(cls, ckpt: str, device=None):
        from ..pipeline.engine import load_engine

        return cls(load_engine(ckpt, device=device))

    def run(self, prompt: str, negative: str = "", seed: int = -1,
            steps: int = 28, guidance_scale: float = 7.0,
            sampler: str = "Euler a", aspect: str = "896 x 1152",
            custom_width: int = 1024, custom_height: int = 1024,
            quality: str = "Standard v3.1", style: str = "(None)",
            add_quality_tags: bool = True, use_upscaler: bool = False,
            upscaler_strength: float = 0.55, upscale_by: float = 1.5
            ) -> np.ndarray:
        from ..pipeline.processing import Processing, process_images

        if add_quality_tags:
            prompt, negative = apply_preset(QUALITY_TAGS, quality, prompt, negative)
        prompt, negative = apply_preset(STYLES, style, prompt, negative)
        w, h = pick_size(aspect, custom_width, custom_height)
        p = Processing(
            prompt=prompt, negative_prompt=negative, seed=seed, steps=steps,
            width=w, height=h, cfg_scale=guidance_scale, sampler_name=sampler,
            do_not_save_samples=True, do_not_save_grid=True)
        if use_upscaler:
            p.enable_hr = True
            p.hr_scale = upscale_by
            p.hr_upscaler = "Latent (nearest-exact)"
            p.hr_denoising_strength = upscaler_strength
        return process_images(self.engine, p).images[0]


PAGE = """<!doctype html><html><head><title>Animagine XL</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%}input[type=text]{width:100%}
label{display:block;margin:.4em 0}select{margin-right:1em}
button{padding:.5em 1.5em}</style></head><body><h2>Animagine XL 3.1</h2>
<label>Prompt <input type=text id=p value="1girl, souryuu asuka langley, neon genesis evangelion"></label>
<label>Negative <input type=text id=n></label>
<label>Quality <select id=q>%QUALITY%</select>
Style <select id=s>%STYLES%</select>
Aspect <select id=a>%ASPECTS%</select></label>
<label><input type=checkbox id=up> 1.5&times; upscale pass</label>
<label>Seed <input type=number id=seed value=-1></label>
<button onclick="go()">Generate</button>
<div><img id=out></div>
<script>
async function go(){
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({prompt:document.getElementById('p').value,
   negative:document.getElementById('n').value,
   quality:document.getElementById('q').value,
   style:document.getElementById('s').value,
   aspect:document.getElementById('a').value,
   use_upscaler:document.getElementById('up').checked,
   seed:parseInt(document.getElementById('seed').value)})});
 const j=await r.json();
 if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>""".replace(
    "%QUALITY%", "".join(f"<option>{k}</option>" for k in QUALITY_TAGS)).replace(
    "%STYLES%", "".join(f"<option>{k}</option>" for k in STYLES)).replace(
    "%ASPECTS%", "".join(f"<option>{k}</option>" for k in ASPECT_RATIOS))


def process(body, pipe):
    out = pipe.run(
        body.get("prompt", ""), body.get("negative", ""),
        seed=int(body.get("seed", -1)),
        quality=body.get("quality", "Standard v3.1"),
        style=body.get("style", "(None)"),
        aspect=body.get("aspect", "896 x 1152"),
        use_upscaler=bool(body.get("use_upscaler")))
    return {"image": encode_answer(out)}


def _setup(args):
    return AnimaginePipeline.from_file(args.ckpt, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    root = os.path.join(os.path.dirname(__file__), "..", "..")
    run_space("animagine space", PAGE, process, default_port=7872, args=[
        ("--ckpt", {"default": os.environ.get(
            "ANIMAGINE_CKPT", os.path.join(root, "models", "checkpoints",
                                           "animagine-xl-3.1.safetensors"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
