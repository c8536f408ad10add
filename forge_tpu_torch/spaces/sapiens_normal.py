# Copied from extensions-builtin/forge_space_sapiens_normal/forge_app.py (PAGE, process, the arguments).
"""The normal-estimation Space: a photograph of a person in, the normal
map out, its background masked (models/sapiens.py `SapiensNormal`).

Run: python -m forge_tpu_torch.spaces.sapiens_normal --host 127.0.0.1 --port 7870
     [--model-dir DIR] [--mask-model-dir DIR] [--device cpu]

The background mask's U²-Net weights are read from --mask-model-dir, by
default $U2NET_MODEL_DIR or the repository's models/u2net, where the
background-removal Space reads them too (the reference reads models/u2net
under the Space's own folder, where no weights are, and so skips the mask).
"""

import os

from . import decode_upload, encode_answer

PAGE = """<!doctype html><html><head><title>Sapiens Normal Estimation</title>
<style>body{font-family:sans-serif;background:#000;color:#eee;max-width:720px;
margin:2em auto}img{max-width:100%%}button{padding:.5em 1.5em}</style>
</head><body>
<h2>Normal Estimation (Sapiens)</h2>
<input type=file id=f accept=image/*>
<label><input type=checkbox id=mask checked> mask background</label>
<button onclick="go()">Run</button>
<div><img id=out></div>
<script>
async function go(){
 const file=document.getElementById('f').files[0]; if(!file)return;
 const b=await file.arrayBuffer();
 const b64=btoa(new Uint8Array(b).reduce((s,c)=>s+String.fromCharCode(c),''));
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({image:b64,mask:document.getElementById('mask').checked})});
 const j=await r.json();
 if(j.error){alert(j.error);return}
 document.getElementById('out').src='data:image/png;base64,'+j.image;
}
</script></body></html>"""


def process(body, net):
    img = decode_upload(body["image"])
    return {"image": encode_answer(net.normals(img, mask_background=bool(body.get("mask", True))))}


def _setup(args):
    from ..models.sapiens import SapiensNormal

    return SapiensNormal(model_dir=args.model_dir, mask_model_dir=args.mask_model_dir,
                         device=args.device)


def main(argv=None):
    from ..runtime.space_harness import run_space

    run_space("sapiens space", PAGE, process, default_port=7870, args=[
        ("--model-dir", {"default": os.environ.get(
            "SAPIENS_MODEL_DIR", os.path.join(os.path.dirname(__file__), "..", "..", "models",
                                              "sapiens"))}),
        ("--mask-model-dir", {"default": os.environ.get(
            "U2NET_MODEL_DIR", os.path.join(os.path.dirname(__file__), "..", "..", "models",
                                            "u2net"))}),
    ], setup=_setup, argv=argv)


if __name__ == "__main__":
    main()
