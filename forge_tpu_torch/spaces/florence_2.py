# Copied from extensions-builtin/forge_space_florence_2/forge_app.py (PAGE, process, the arguments).
"""The captioning Space: an image in, a BLIP caption and the DeepDanbooru
tags out (models/blip.py `BlipCaptioner`, postprocessing/deepbooru.py
`DeepDanbooru`).

Run: python -m forge_tpu_torch.spaces.florence_2 --host 127.0.0.1 --port 7871
     [--model-root DIR] [--device cpu]
"""

import os

from . import decode_upload

PAGE = """<!doctype html><html><head><title>Image Caption</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%%}textarea{width:100%%;background:#1a1a1a;
color:#eee}button{padding:.5em 1.5em}</style></head><body>
<h2>Image Caption</h2>
<input type=file id=f accept=image/*>
<label><input type=checkbox id=tags checked> booru tags</label>
<button onclick="go()">Caption</button>
<div><textarea id=out rows=6 readonly></textarea></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,tags:document.getElementById('tags').checked})});
 const j=await r.json();
 document.getElementById('out').value=j.error||((j.caption||'')+(j.tags?'\\n\\n'+j.tags:''));
}
</script></body></html>"""


def process(body, state):
    img = decode_upload(body["image"])
    out = {}
    if state["blip"].available:
        out["caption"] = state["blip"].caption(img)
    if body.get("tags") and state["booru"].available:
        out["tags"] = state["booru"].tag(img)
    if not out:
        out["error"] = ("no captioner checkpoints found — put BLIP "
                        "under models/BLIP or deepbooru under "
                        "models/torch_deepdanbooru")
    return out


def _setup(args):
    from ..models.blip import BlipCaptioner
    from ..postprocessing.deepbooru import DeepDanbooru

    return {"blip": BlipCaptioner(os.path.join(args.model_root, "BLIP"), device=args.device),
            "booru": DeepDanbooru(os.path.join(args.model_root, "torch_deepdanbooru"),
                                  device=args.device)}


def main(argv=None):
    from ..runtime.space_harness import run_space

    run_space("caption space", PAGE, process, default_port=7871, args=[
        ("--model-root", {"default": os.environ.get(
            "CAPTION_MODEL_ROOT",
            os.path.join(os.path.dirname(__file__), "..", "..", "models"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
