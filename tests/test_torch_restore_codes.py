"""CodeFormer restore at the synth's own position embedding, the port's
decoded image handed to forge_tpu's finish (CPU, f32).

tests/test_torch_restore_slice.py runs `restore_faces` through both
`process_images` with the tiny CodeFormer's position embedding scaled 50×:
the two packages' unrestored 64² images differ by one level at one pixel,
and at the synth's own N(0, 0.02²) embedding that flips one of the 256
codes. The level is float32 noise at a level boundary, not a fault of the
port: there the decoded value (x + 1)·127.5 + 0.5 is 128.0 in the port and
just under 128 in forge_tpu's fused decode (its same graph jitted alone
gives 128.0, and either VAE on the other package's latent 127.99998 to
127.99999), from latents that differ by 5.7e-5 (1.3e-6 of their largest
value). So here, at the synth's own embedding, forge_tpu's finish is handed
the port's decoded image (a `postprocess_batch` script returns it, as
tests/test_torch_soft_inpainting.py does for colour correction): both
restorers see the same 512² face crop, pick the same codes, one for one,
and give the same restored image (the golden bar, 40 dB); the infotexts are
equal and name the restorer.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_codeformer import reference_codes  # noqa: E402
from test_torch_restore_slice import REQUEST, _psnr  # noqa: E402
from torch_restoration_cases import reference_tree, tiny_sd, write  # noqa: E402


def _batch_script(package, seen, replace=None):
    """A runner whose script records the decoded batch (before the restore)
    and, given `replace`, hands that batch on in its place."""
    mod = importlib.import_module(f"{package}.runtime.scripts")

    class Batch(mod.Script):
        name = "batch"

        def postprocess_batch(self, p, images, **kw):
            seen.append(np.array(images))
            return replace

    runner = mod.ScriptRunner()
    runner.register(Batch())
    return runner


def test_restore_of_the_ports_image_matches_code_for_code(tmp_path, monkeypatch):
    import jax

    from forge_tpu.models.codeformer import codeformer_apply as jcodeformer_apply
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.postprocessing import faces as jfaces
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.postprocessing import faces

    sd = tiny_sd("codeformer", seed=11)  # the synth's own position embedding, N(0, 0.02²)
    d = tmp_path / "Codeformer"
    write(sd, str(d / "codeformer-v0.1.0.safetensors"))
    restorer = faces.FaceRestorer(model_dir=str(d), device="cpu")
    codes, crops = [], {"port": [], "ref": []}
    port_crop = restorer.restore_crop

    def record_port(crop, w, codes_out=None):
        crops["port"].append(np.array(crop))
        return port_crop(crop, w, codes)

    restorer.restore_crop = record_port
    jrestorer = jfaces.FaceRestorer(params=reference_tree(sd))
    jitted = jax.jit(jcodeformer_apply, static_argnames=("w", "adain"))

    def record_ref(params, x, w):
        crops["ref"].append(np.asarray((x[0] + 1.0) * 127.5))
        return jitted(params, x, w=w)

    jrestorer._apply = record_ref
    monkeypatch.setattr(faces, "_restorer", restorer)
    monkeypatch.setattr(jfaces, "_restorer", jrestorer)

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    decoded = []
    tp = tproc.Processing(**REQUEST, restore_faces=True,
                          scripts=_batch_script("forge_tpu_torch", decoded))
    got = tproc.process_images(teng, tp)
    jp = jproc.Processing(**REQUEST, restore_faces=True)
    jp.scripts = _batch_script("forge_tpu", [], replace=decoded[0])
    want = jproc.process_images(make_tiny_engine(0), jp)

    assert len(crops["port"]) == len(crops["ref"]) == 1
    assert np.array_equal(np.round(crops["ref"][0]).astype(np.uint8), crops["port"][0])
    x = jnp.asarray(crops["port"][0], jnp.float32)[None] / 127.5 - 1.0
    ref_codes = reference_codes(reference_tree(sd), x)
    assert ref_codes.shape == (1, 256) and len(np.unique(ref_codes)) > 4
    assert np.array_equal(codes[0].numpy(), ref_codes)
    assert _psnr(got.images[0], want.images[0]) >= 40.0
    assert not np.array_equal(got.images[0], decoded[0][0])
    assert got.infotexts == want.infotexts and "Face restoration: CodeFormer" in got.infotexts[0]
