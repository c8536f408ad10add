"""`restore_faces` through the port's `process_images` against forge_tpu's
(CPU, f32), and the missing-checkpoint departure.

The tiny SD1.5 (tests/fixtures.py) at 64², 5 steps, DPM++ 2M Karras, CFG 7,
seed 1, with both packages' CodeFormer restorer over the same tiny file at
face size 512 (tests/torch_restoration_cases.py; its position embedding
at N(0, 1), so that the codes, an argmax, do not flip on the unrestored
images' one-level difference at one pixel: float32 noise at a level
boundary, the decoded value 128.0 in the port and just under 128 in
forge_tpu's fused decode; tests/test_torch_restore_codes.py holds the
restore at the synth's own embedding, forge_tpu's finish handed the port's
decoded image): the restored image
reaches PSNR ≥ 40 dB against forge_tpu's (the golden bar), the infotexts
are equal and hold "Face restoration: CodeFormer", and the image is not the
unrestored one. The `face_restoration` option without the field gives the
same bytes and infotext. With no checkpoint the reference prints and skips
(its image is the unrestored one, its infotext still saying "Face
restoration: CodeFormer"); the port
raises `RestorerMissing` naming the directory, and its API answers 422.
Serving refuses the field and the option, as the reference's serving never
restores.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402
from test_torch_api import _call, _serve  # noqa: E402
from torch_restoration_cases import reference_tree, tiny_sd, write  # noqa: E402

# The two packages' unrestored images differ by one level at one pixel (float32 noise: the
# decoded value sits on the 128 boundary, 128.0 in the port and just under in forge_tpu); at
# the synthetic position embedding's N(0, 0.02²) that flips one of the 256 codes the tiny
# transformer picks (35 dB); at N(0, 1) the codes are the same on both images.
POSITION_GAIN = 50.0
REQUEST = dict(prompt="a portrait of a woman", negative_prompt="blurry", seed=1, steps=5,
               width=64, height=64, cfg_scale=7.0, sampler_name="DPM++ 2M", scheduler="karras")


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """(forge_tpu's tiny engine, the port's, the Codeformer directory); both
    packages' restorers over one tiny file; params.txt off."""
    from forge_tpu.postprocessing import faces as jfaces
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine
    from forge_tpu_torch.postprocessing import faces
    from forge_tpu_torch.runtime.options import opts

    d = tmp_path_factory.mktemp("models") / "Codeformer"
    sd = tiny_sd("codeformer", seed=11)
    sd["position_emb"] = sd["position_emb"] * POSITION_GAIN
    write(sd, str(d / "codeformer-v0.1.0.safetensors"))
    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(faces, "_restorer", faces.FaceRestorer(model_dir=str(d), device="cpu"))
        mp.setattr(jfaces, "_restorer", jfaces.FaceRestorer(params=reference_tree(sd)))
        with opts.override({"save_write_params_txt": False}):
            yield make_tiny_engine(0), teng, d


def _run(package, engine, **fields):
    proc = __import__(f"{package}.pipeline.processing", fromlist=["_"])
    return proc.process_images(engine, proc.Processing(**REQUEST, **fields))


@pytest.fixture(scope="module")
def restored(engines):
    jeng, teng, _ = engines
    return {"ref": _run("forge_tpu", jeng, restore_faces=True),
            "port": _run("forge_tpu_torch", teng, restore_faces=True),
            "plain": _run("forge_tpu_torch", teng)}


def test_restore_faces_matches_reference(restored):
    ref, port, plain = restored["ref"], restored["port"], restored["plain"]
    assert port.images[0].shape == (64, 64, 3) and port.images[0].dtype == np.uint8
    assert _psnr(port.images[0], ref.images[0]) >= 40.0
    assert port.infotexts == ref.infotexts
    assert "Face restoration: CodeFormer" in port.infotexts[0]
    assert "Face restoration" not in plain.infotexts[0]
    assert _psnr(port.images[0], plain.images[0]) < 30.0


def test_face_restoration_option(engines, restored):
    from forge_tpu_torch.runtime.options import opts

    _, teng, _ = engines
    with opts.override({"face_restoration": True}):
        res = _run("forge_tpu_torch", teng)
    assert np.array_equal(res.images[0], restored["port"].images[0])
    assert res.infotexts == restored["port"].infotexts


def test_missing_checkpoint_both_sides(engines, restored, tmp_path, monkeypatch, capsys):
    """forge_tpu prints and gives the unrestored image under an infotext that
    names the restorer; the port raises
    RestorerMissing (a FileNotFoundError) naming the directory; the API 422."""
    from forge_tpu.postprocessing import faces as jfaces
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.postprocessing import faces
    from forge_tpu_torch.runtime.models import ModelManager

    jeng, teng, _ = engines
    empty = str(tmp_path / "Codeformer")
    monkeypatch.setattr(jfaces, "_restorer", jfaces.FaceRestorer(model_dir=empty))
    monkeypatch.setattr(faces, "_restorer", faces.FaceRestorer(model_dir=empty, device="cpu"))
    ref = _run("forge_tpu", jeng, restore_faces=True)
    assert "skipped" in capsys.readouterr().out
    assert "Face restoration: CodeFormer" in ref.infotexts[0]  # it claims the skipped step
    assert _psnr(ref.images[0], restored["plain"].images[0]) >= 40.0
    with pytest.raises(faces.RestorerMissing, match=empty):
        _run("forge_tpu_torch", teng, restore_faces=True)
    assert issubclass(faces.RestorerMissing, FileNotFoundError)
    tmm = ModelManager(device="cpu")
    tmm.set_engine(teng)
    srv = create_server(tmm, "127.0.0.1", 0)
    try:
        status, body, _ = _call(_serve(srv), "/sdapi/v1/txt2img",
                                dict(REQUEST, restore_faces=True))
    finally:
        srv.shutdown()
        srv.server_close()
        tmm.close()
    assert status == 422 and "no CodeFormer checkpoint" in body["detail"], body


def test_serving_refuses_restore_faces(engines):
    from forge_tpu_torch.pipeline.processing import Processing
    from forge_tpu_torch.runtime.options import opts
    from forge_tpu_torch.runtime.serving import ServingPipeline

    _, teng, _ = engines
    pipe = ServingPipeline(teng, depth=2)
    try:
        fut = pipe.submit(Processing(**REQUEST, restore_faces=True))
        with pytest.raises(NotImplementedError, match="restore_faces"):
            fut.result(timeout=60)
        opts.set("face_restoration", True)  # the serving threads see set options only
        try:
            fut = pipe.submit(Processing(**REQUEST))
            with pytest.raises(NotImplementedError, match="face_restoration"):
                fut.result(timeout=60)
        finally:
            opts.set("face_restoration", False)
    finally:
        pipe.close()
