# Copied from extensions-builtin/forge_space_example/forge_app.py (PAGE, greet, process).
"""The example Space: the minimal template a user copies to write a Space,
a greeter echoing its input (the two-file contract of runtime/spaces.py).

Run: python -m forge_tpu_torch.spaces.example --host 127.0.0.1 --port 7876
"""

PAGE = """<!doctype html><html><head><title>Example Space</title>
<style>body{font-family:sans-serif;background:#111;color:#eee;max-width:480px;
margin:2em auto}button{padding:.5em 1.5em}</style></head><body>
<h2>Example Space</h2>
<input type=text id=name value=world>
<input type=range id=intensity min=1 max=5 value=1>
<button onclick="go()">Greet</button>
<p id=out></p>
<script>
async function go(){
 const r=await fetch('/process',{method:'POST',headers:{'Content-Type':'application/json'},
  body:JSON.stringify({name:document.getElementById('name').value,
   intensity:parseInt(document.getElementById('intensity').value)})});
 document.getElementById('out').textContent=(await r.json()).greeting;
}
</script></body></html>"""


def greet(name: str, intensity: int) -> str:
    return "Hello, " + name + "!" * int(intensity)


def process(body, state):
    return {"greeting": greet(str(body.get("name", "world")), int(body.get("intensity", 1)))}


def main(argv=None):
    from ..runtime.space_harness import run_space

    run_space("example space", PAGE, process, default_port=7876, argv=argv)


if __name__ == "__main__":
    main()
