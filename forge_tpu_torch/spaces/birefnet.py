# Copied from extensions-builtin/forge_space_birefnet/forge_app.py (PAGE, process, the arguments).
"""The background-removal Space: an image in, its transparent cutout or a
flat-colour composite out (models/u2net.py `U2NetMatter`).

Run: python -m forge_tpu_torch.spaces.birefnet --host 127.0.0.1 --port 7870
     [--model-dir DIR] [--device cpu]
"""

import os

from . import decode_upload, encode_answer

PAGE = """<!doctype html><html><head><title>Remove Background</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%%;background:
repeating-conic-gradient(#333 0 25%,#222 0 50%) 0 0/20px 20px}
button{padding:.5em 1.5em}</style></head><body>
<h2>Remove Background</h2>
<input type=file id=f accept=image/*>
<label><input type=checkbox id=flat> flat background</label>
<input type=color id=bg value="#ffffff">
<button onclick="go()">Process</button>
<div><img id=out></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,flat:document.getElementById('flat').checked,
                       bg:document.getElementById('bg').value})});
 const j=await r.json();
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>"""


def process(body, matter):
    img = decode_upload(body["image"])
    flat = None
    if body.get("flat"):
        hexc = (body.get("bg") or "#ffffff").lstrip("#")
        flat = tuple(int(hexc[i:i + 2], 16) for i in (0, 2, 4))
    size = int(body.get("size") or 320)
    return {"image": encode_answer(matter.cutout(img, flat_bg=flat, size=size))}


def _setup(args):
    from ..models.u2net import U2NetMatter

    return U2NetMatter(model_dir=args.model_dir, device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    run_space("birefnet space", PAGE, process, default_port=7870, args=[
        ("--model-dir", {"default": os.environ.get(
            "U2NET_MODEL_DIR", os.path.join(os.path.dirname(__file__), "..", "..", "models",
                                            "u2net"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
