"""The extras routes (POST /sdapi/v1/extra-single-image and
/sdapi/v1/extra-batch-images) of the port's server against forge_tpu's
(CPU, f32), both servers over the same tiny model files
(tests/torch_restoration_cases.py): a real-SR SwinIR in models/SwinIR and
the CodeFormer and GFPGAN restorers at face size 512.

Each payload's PNGs decode to forge_tpu's pixels within 2 levels (the
restorer's and the upscaler's last steps truncate to uint8 on both sides,
values within 1e-5 of an integer going either way): face restoration
blended by max(codeformer_visibility, gfpgan_visibility) with the
restorer the option names (GFPGAN ignores codeformer_weight, as the
reference's), resize modes 0 and 1, the centre crop on and off, and
`upscaler_2` blended by `extras_upscaler_2_visibility` (run on the input
as it came, as the reference's), and the crop of resize mode 1 with
`focal_crop_enabled` under several weight sets (postprocessing/focal_crop.py;
the face term is left out on both sides, there being no Haar cascade data).
/sdapi/v1/upscalers lists what forge_tpu's lists. The port answers 422 for a
restorer without its checkpoint (where the reference skips it), and
/sdapi/v1/interrogate answers 404 without an image and, without a CLIP
checkpoint, the reference's `detail`.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import base64
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image  # noqa: E402

from test_torch_api import _call, _png_b64, _serve  # noqa: E402
from torch_restoration_cases import reference_gfpgan_tree, reference_tree, tiny_sd, write  # noqa: E402

IMAGES = [np.random.default_rng(i).integers(0, 256, (48, 40, 3), dtype=np.uint8) for i in (1, 2)]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    import jax

    from forge_tpu.api.server import create_server as jcreate
    from forge_tpu.pipeline import upscalers as jup
    from forge_tpu.postprocessing import faces as jfaces
    from forge_tpu.postprocessing import gfpgan as jgfpgan
    from forge_tpu.runtime.models import ModelManager as JManager
    from forge_tpu_torch.api.server import create_server
    from forge_tpu_torch.pipeline import upscalers as tup
    from forge_tpu_torch.postprocessing import faces
    from forge_tpu_torch.postprocessing import gfpgan
    from forge_tpu_torch.runtime.models import ModelManager

    d = tmp_path_factory.mktemp("models")
    write(tiny_sd("swinir", seed=31, upsampler="nearest+conv", scale=4),
          str(d / "SwinIR" / "swinir_tiny.safetensors"))
    cf, gf = tiny_sd("codeformer", seed=32), tiny_sd("gfpgan", seed=33)
    write(cf, str(d / "Codeformer" / "codeformer.safetensors"))
    write(gf, str(d / "GFPGAN" / "GFPGANv1.4.safetensors"))
    dirs = {"ESRGAN": str(d / "ESRGAN"), "SwinIR": str(d / "SwinIR")}
    jgf = jgfpgan.GFPGAN(model_dir=str(d / "GFPGAN"))
    jgf.params = reference_gfpgan_tree(gf)  # its load transposes constant_input
    jgf._jit = jax.jit(lambda t: jgfpgan.gfpgan_apply(jgf.params, t))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jup, "_DEFAULT_REGISTRY", jup.UpscalerRegistry(model_dirs=dirs))
        mp.setattr(tup, "_DEFAULT_REGISTRY", tup.UpscalerRegistry(model_dirs=dirs, device="cpu"))
        mp.setattr(jfaces, "_restorer", jfaces.FaceRestorer(params=reference_tree(cf)))
        mp.setattr(faces, "_restorer", faces.FaceRestorer(model_dir=str(d / "Codeformer"),
                                                          device="cpu"))
        mp.setattr(jgfpgan, "_MODEL", jgf)
        mp.setattr(gfpgan, "_MODEL", gfpgan.GFPGAN(model_dir=str(d / "GFPGAN"), device="cpu"))
        jmm, tmm = JManager(), ModelManager(device="cpu")
        jsrv, tsrv = jcreate(jmm, "127.0.0.1", 0), create_server(tmm, "127.0.0.1", 0)
        yield _serve(jsrv), _serve(tsrv), d
        for srv in (jsrv, tsrv):
            srv.shutdown()
            srv.server_close()
        tmm.close()


def _decode(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert("RGB"))


def _both(servers, route, payload, option=None):
    """Each server's decoded images for one payload; `option` sets
    face_restoration_model in both packages (the handler threads see set
    options only) and resets it."""
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.runtime.options import opts

    if option:
        opts.set("face_restoration_model", option)
        jopts.set("face_restoration_model", option)
    try:
        answers = []
        for base in servers[:2]:
            status, body, _ = _call(base, route, payload)
            assert status == 200, body
            answers.append([_decode(b) for b in ([body["image"]] if "image" in body
                                                  else body["images"])])
    finally:
        opts.set("face_restoration_model", "CodeFormer")
        jopts.set("face_restoration_model", "CodeFormer")
    return answers


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.uint8
        diff = np.abs(g.astype(np.int16) - w)
        assert diff.max() <= 2 and diff.mean() < 0.05, (diff.max(), diff.mean())


@pytest.mark.parametrize("fields,option,shape", [
    (dict(upscaler_1="swinir_tiny", upscaling_resize=2, codeformer_visibility=1.0), None,
     (96, 80, 3)),
    (dict(upscaler_1="swinir_tiny", upscaling_resize=4), None, (192, 160, 3)),
    (dict(upscaler_1="Lanczos", upscaling_resize=1.5, gfpgan_visibility=0.6,
          codeformer_weight=0.0), "GFPGAN", (72, 60, 3)),
])
def test_extra_single_image(servers, fields, option, shape):
    want, got = _both(servers, "/sdapi/v1/extra-single-image",
                      dict(image=_png_b64(IMAGES[0]), **fields), option)
    _close(got, want)
    assert got[0].shape == shape


@pytest.mark.parametrize("fields", [
    dict(resize_mode=1, upscaling_resize_w=100, upscaling_resize_h=70, upscaling_crop=True,
         upscaler_1="swinir_tiny", upscaler_2="Lanczos", extras_upscaler_2_visibility=0.4),
    dict(resize_mode=1, upscaling_resize_w=100, upscaling_resize_h=70, upscaling_crop=False,
         upscaler_1="Lanczos", upscaler_2="swinir_tiny", extras_upscaler_2_visibility=0.7,
         codeformer_visibility=0.5, codeformer_weight=0.3),
    dict(resize_mode=1, upscaling_resize_w=41, upscaling_resize_h=99, upscaler_1="Nearest"),
])
def test_extra_batch_images(servers, fields):
    payload = dict(imageList=[{"data": _png_b64(img), "name": f"{i}.png"}
                              for i, img in enumerate(IMAGES)], **fields)
    want, got = _both(servers, "/sdapi/v1/extra-batch-images", payload)
    _close(got, want)
    assert all(g.shape == (fields["upscaling_resize_h"], fields["upscaling_resize_w"], 3)
               for g in got)


def test_gfpgan_ignores_codeformer_weight(servers):
    images = [_both(servers, "/sdapi/v1/extra-single-image",
                    dict(image=_png_b64(IMAGES[1]), upscaler_1="None", gfpgan_visibility=1.0,
                         codeformer_weight=w), "GFPGAN")[1][0] for w in (0.0, 1.0)]
    assert np.array_equal(images[0], images[1])
    assert np.abs(images[0].astype(np.int16) - IMAGES[1]).mean() > 5


def test_upscaler_listing_matches_reference(servers):
    listings = [_call(base, "/sdapi/v1/upscalers")[1] for base in servers[:2]]
    assert listings[0] == listings[1]
    assert {u["name"] for u in listings[1]} == {"None", "Lanczos", "Nearest", "swinir_tiny"}


def test_refusals(servers, monkeypatch):
    from forge_tpu_torch.postprocessing import faces

    tbase = servers[1]
    for payload, want_status in (({"image": ""}, 404), ({"image": _png_b64(IMAGES[0])}, 200)):
        answers = [_call(base, "/sdapi/v1/interrogate", payload)[:2] for base in servers[:2]]
        assert answers[0] == answers[1] and answers[1][0] == want_status, answers
    monkeypatch.setattr(faces, "_restorer", faces.FaceRestorer(model_dir="no/such/dir",
                                                               device="cpu"))
    status, body, _ = _call(tbase, "/sdapi/v1/extra-single-image",
                            dict(image=_png_b64(IMAGES[0]), codeformer_visibility=1.0))
    assert status == 422 and "no/such/dir" in body["detail"]


@pytest.mark.parametrize("fields", [
    dict(upscaler_1="Lanczos", upscaling_resize_w=80, upscaling_resize_h=48),
    dict(upscaler_1="Lanczos", upscaling_resize_w=48, upscaling_resize_h=96,
         focal_crop_face_weight=0.0, focal_crop_entropy_weight=1.0, focal_crop_edges_weight=0.0),
    dict(upscaler_1="swinir_tiny", upscaling_resize_w=100, upscaling_resize_h=60,
         focal_crop_entropy_weight=0.0, focal_crop_edges_weight=1.0),
])
def test_focal_crop_matches_reference(servers, fields):
    payload = dict(fields, image=_png_b64(IMAGES[1]), resize_mode=1, focal_crop_enabled=True)
    want, got = _both(servers, "/sdapi/v1/extra-single-image", payload)
    _close(got, want)
    assert got[0].shape == (fields["upscaling_resize_h"], fields["upscaling_resize_w"], 3)
    centre, _ = _both(servers, "/sdapi/v1/extra-single-image",
                      dict(payload, focal_crop_enabled=False))
    assert not np.array_equal(got[0], centre[0])  # the focal window is not the centre's
