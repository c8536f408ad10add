"""Tiny files, the reference apps and the children shared by
tests/test_torch_space_apps_sd15.py and tests/test_torch_space_apps_sdxl.py.

The Spaces' bodies leave the size to the app where the reference's page does
(Animagine's aspect presets, Illusion's 512² → 1024², IC-Light's 512² →
768²), so a child answers at the app's default size. The `fast_*` files keep
that cheap on the CPU: a four-level UNet whose one transformer is its middle
block (at 1/64 of the latent's pixels), a VAE of 32 channels and one
ResBlock a level, and a ControlNet whose hint ladder is 1–2 channels wide.
The small requests held against the reference in-process use the tests'
usual tiny networks (tests/fixtures.py, tests/test_torch_sdxl.py).
"""

import base64
import importlib.util
import io
import json
import os
import shutil
import sys
import threading
import urllib.error
import urllib.request

import numpy as np

from fixtures import CLIP_WIDTH, make_clip_sd

LAUNCH_TIMEOUT = 120.0
REQUEST_TIMEOUT = 300.0
# a UNet whose one transformer block is its middle block, at 1/8 of the latent's side
FAST_UNET = dict(model_channels=32, channel_mult=(1, 1, 1, 1), num_res_blocks=1,
                 transformer_depth=(0, 0, 0, 0), middle_depth=1)
FAST_VAE = dict(ch=32, ch_mult=(1, 1, 1, 1), num_res=1)


def reference_app(folder):
    """A bundled Space's forge_app.py under a module name of its own."""
    name = f"reference_app_{folder}"
    if name in sys.modules:
        return sys.modules[name]
    path = os.path.join("extensions-builtin", folder, "forge_app.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def save(sd, path):
    from forge_tpu_torch.core.save import save_safetensors

    save_safetensors({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path))
    return str(path)


def fast_sd15_sd():
    """An SD1.5 checkpoint: the fast UNet at context 64, the fast VAE, the tiny CLIP-L."""
    from forge_tpu_torch.core.synth import synth_unet_sd, synth_vae_sd

    sd = synth_unet_sd(**FAST_UNET, context_dim=CLIP_WIDTH, fill="random", seed=1,
                       prefix="model.diffusion_model.")
    sd.update(synth_vae_sd(**FAST_VAE, fill="random", seed=2))
    sd.update(make_clip_sd(seed=3))
    return sd


def fast_sdxl_sd():
    """An SDXL checkpoint: tests/test_torch_sdxl.py's tiny text encoders, the fast UNet at
    its context and `y` widths (linear projections, as SDXL's), the fast VAE."""
    from test_torch_sdxl import ADM, CTX, _tiny_sdxl_checkpoint

    from forge_tpu_torch.core.synth import synth_unet_sd, synth_vae_sd

    sd = {k: v for k, v in _tiny_sdxl_checkpoint().items()
          if not k.startswith(("model.diffusion_model.", "first_stage_model."))}
    unet = synth_unet_sd(**FAST_UNET, context_dim=CTX, adm_in_channels=ADM, fill="random",
                         seed=11, prefix="model.diffusion_model.")
    for key in [k for k in unet if k.endswith(("proj_in.weight", "proj_out.weight"))]:
        unet[key] = unet[key][:, :, 0, 0]
    sd.update(unet)
    sd.update(synth_vae_sd(**FAST_VAE, fill="random", seed=12))
    return sd


def idm_vton_sd(seed=31, sharpen=8.0):
    """tests/test_torch_sdxl.py's tiny SDXL with a 13-channel try-on UNet and a 4-channel
    garment UNet under `garment_model.diffusion_model.` (tests/test_spaces.py's layout).
    Their queries and keys are `sharpen` times the synth's, so that attention is far from
    uniform and its heads matter."""
    from test_torch_sdxl import ADM, CTX, _tiny_sdxl_checkpoint

    from forge_tpu_torch.core.synth import synth_unet_sd

    sd = {k: v for k, v in _tiny_sdxl_checkpoint().items()
          if not k.startswith("model.diffusion_model.")}
    common = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=1,
                  transformer_depth=(0, 1), middle_depth=1, context_dim=CTX,
                  adm_in_channels=ADM, fill="random")
    for prefix, channels, s in (("model.diffusion_model.", 13, seed),
                                ("garment_model.diffusion_model.", 4, seed + 1)):
        unet = synth_unet_sd(in_channels=channels, seed=s, prefix=prefix, **common)
        for key in [k for k in unet if k.endswith(("proj_in.weight", "proj_out.weight"))]:
            unet[key] = unet[key][:, :, 0, 0]
        for key in [k for k in unet if k.endswith(("to_q.weight", "to_k.weight"))]:
            unet[key] = unet[key] * sharpen
        sd.update(unet)
    return sd


def fast_cldm_sd(seed=7):
    """A cldm ControlNet of the fast UNet's encoder with a 1–2 channel hint ladder."""
    from forge_tpu_torch.core.synth import synth_controlnet_sd

    kw = {k: v for k, v in FAST_UNET.items() if k != "middle_depth"}
    sd = {k: np.asarray(v) for k, v in synth_controlnet_sd(
        **kw, context_dim=CLIP_WIDTH, adm_in_channels=None, fill="random", seed=seed).items()}
    r = np.random.default_rng(seed)
    ladder = [(1, 3), (1, 1), (2, 1), (2, 2), (2, 2), (2, 2), (2, 2),
              (FAST_UNET["model_channels"], 2)]
    for pos, (o, i) in enumerate(ladder):
        sd[f"input_hint_block.{pos * 2}.weight"] = (r.standard_normal((o, i, 3, 3))
                                                    * 0.3).astype(np.float32)
        sd[f"input_hint_block.{pos * 2}.bias"] = np.zeros(o, np.float32)
    return sd


def iclight_offset_sd(in_channels=8, seed=61):
    """An IC-Light offset at the fast UNet's shapes in diffusers' keys (chip_smoke's
    `ldm_to_diffusers_unet`): small random offsets on every leaf, the stem conv
    `in_channels` wide."""
    from chip_smoke import ldm_to_diffusers_unet

    from forge_tpu_torch.core.synth import synth_unet_sd

    ldm = synth_unet_sd(**FAST_UNET, context_dim=CLIP_WIDTH, in_channels=in_channels,
                        fill="random", seed=seed, prefix="")
    r = np.random.default_rng(seed)
    off = {k: (r.standard_normal(np.shape(v)) * 0.01).astype(np.float32) for k, v in ldm.items()}
    off["input_blocks.0.0.weight"] = (r.standard_normal(np.shape(ldm["input_blocks.0.0.weight"]))
                                      * 0.05).astype(np.float32)
    return ldm_to_diffusers_unet(off, levels=len(FAST_UNET["channel_mult"]),
                                 num_res=FAST_UNET["num_res_blocks"])


def png_b64(img):
    """uint8 pixels → a base64 PNG, as a browser uploads one (Pillow writes it)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def pixels(b64):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def near(got, want, share=0.02):
    """Within one level, on `share` of the values or fewer → (the largest difference, the
    share of the values that differ)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    largest, differ = int(diff.max()), float((diff > 0).mean())
    assert largest <= 1 and differ <= share, (largest, differ)
    return largest, differ


def image(h, w, seed):
    """A smooth RGB test photo."""
    from forge_tpu_torch.pipeline.images import bilinear_resize

    r = np.random.default_rng(seed)
    return bilinear_resize(r.integers(0, 256, (8, 8, 3), dtype=np.uint8), w, h)


def post(url, body):
    req = urllib.request.Request(url + "/process", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=REQUEST_TIMEOUT) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Children:
    """The port's Spaces as children with `--device cpu`, each working in a copy of its
    bundled folder under `root` (a diffusion Space writes params.txt and logs/ in its
    working directory, as the reference's does)."""

    def __init__(self, root, folders):
        from forge_tpu_torch.runtime.spaces import SpaceManager

        ext = os.path.join(str(root), "extensions-builtin")
        for folder in folders:
            shutil.copytree(os.path.join("extensions-builtin", folder), os.path.join(ext, folder))
        self.manager = SpaceManager([ext])
        self.urls = {}

    def launch(self, launches):
        """{folder: its arguments} → {folder: URL}, launched at once, one thread each."""
        env = dict(os.environ, OMP_NUM_THREADS="1")
        errors = []

        def one(folder, args):
            try:
                self.urls[folder] = self.manager.launch(folder, timeout=LAUNCH_TIMEOUT, env=env,
                                                        args=["--device", "cpu"] + list(args))
            except Exception as e:  # noqa: BLE001 — raised below
                errors.append((folder, e))

        threads = [threading.Thread(target=one, args=item) for item in launches.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0][1]
        return self.urls

    def post_while(self, folder, body, work):
        """POST body to the child in a thread while `work()` runs here → (its answer, work's)."""
        box = {}
        t = threading.Thread(target=lambda: box.update(answer=post(self.urls[folder], body)))
        t.start()
        try:
            mine = work()
        finally:
            t.join()
        return box["answer"], mine

    def close(self):
        self.manager.terminate_all()
        assert not any(s.running for s in self.manager.spaces.values())
