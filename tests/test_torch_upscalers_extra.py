"""The port's HAT, DAT and SCUNet (forge_tpu_torch/models/hat.py, dat.py,
scunet.py) and the upscaler registry's sniffing and tile options, against
forge_tpu's (CPU, f32).

Each tiny network (tests/torch_restoration_cases.py) is read from one
`.safetensors` file by both packages' loaders and matches within 1e-4 of
the output's largest value, its meta equal; at the published widths
(HAT_SRx4, DAT_x4, SCUNet color real PSNR) the synthetic files' meta is
equal too. HAT's and DAT's upsample convs are reordered for forge_tpu's
pixel shuffle (tests/test_torch_swinir.py shows that divergence). The
registry names each file's network by its keys as forge_tpu's does
(`sniff_architecture`), upscales it as forge_tpu's registry does (uint8
within 1), and tiles it with the options its directory's kind picks
(SWIN_tile for "SwinIR", DAT_tile for "DAT", ESRGAN_tile for "HAT" and any
other; a tile of 0 becomes 192): the tiles and overlaps both registries
call their network with are equal. SCUNet's upstream [heads, 15, 15]
table, which the reference misreads, raises ValueError in the port.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from torch_restoration_cases import (nchw, nhwc, port_tree, reference_sd, reference_tree,  # noqa: E402
                                     rel_err, tiny_sd, write)

SPLIT = (2, 4)  # DAT's axial windows at the tiny size


def _pair(arch, tmp_path):
    from forge_tpu_torch.core.state_dict import load_state_dict

    ref = __import__(f"forge_tpu.models.{arch}", fromlist=["_"])
    port = __import__(f"forge_tpu_torch.models.{arch}", fromlist=["_"])
    sd = tiny_sd(arch, seed=3)
    path = write(sd, str(tmp_path / f"{arch}.safetensors"))
    jpath = write(reference_sd(sd), str(tmp_path / f"{arch}_ref.safetensors"))
    jparams = getattr(ref, f"load_{arch}")(jpath)
    tparams = port_tree(getattr(port, f"load_{arch}")(load_state_dict(path)))
    return ref, port, jparams, tparams


@pytest.mark.parametrize("arch,meta", [
    ("hat", {"window_size": 4, "heads": 2, "scale": 2, "overlap_ratio": 0.5}),
    ("dat", {"heads": 2, "scale": 2}),
    ("scunet", {"head_dim": 2}),
])
def test_network_matches_reference(tmp_path, arch, meta):
    ref, port, jparams, tparams = _pair(arch, tmp_path)
    assert getattr(port, f"infer_{arch}_meta")(tparams) == meta
    assert getattr(ref, f"infer_{arch}_meta")(jparams) == meta
    kw = dict(meta, split=SPLIT) if arch == "dat" else meta
    x = np.random.default_rng(4).uniform(0, 1, (1, 10, 14, 3)).astype(np.float32)
    want = np.asarray(getattr(ref, f"{arch}_apply")(jparams, jnp.asarray(x), **kw))
    got = nhwc(getattr(port, f"{arch}_apply")(tparams, nchw(x), **kw))
    scale = meta.get("scale", 1)
    assert got.shape == want.shape == (1, 10 * scale, 14 * scale, 3)
    assert rel_err(got, want) < 1e-4


@pytest.mark.parametrize("arch,meta", [
    ("hat", {"window_size": 16, "heads": 6, "scale": 4, "overlap_ratio": 0.5}),
    ("dat", {"heads": 6, "scale": 4}),
    ("scunet", {"head_dim": 32}),
])
def test_published_widths_meta(arch, meta):
    from forge_tpu_torch.core import synth
    from forge_tpu_torch.core.convert import nest

    ref = __import__(f"forge_tpu.models.{arch}", fromlist=["_"])
    port = __import__(f"forge_tpu_torch.models.{arch}", fromlist=["_"])
    sd = getattr(synth, f"synth_{arch}_sd")(fill="zeros")
    tree = nest({k: torch.from_numpy(v) for k, v in sd.items()})
    assert getattr(port, f"infer_{arch}_meta")(tree) == meta
    assert getattr(ref, f"infer_{arch}_meta")(reference_tree(sd)) == meta


def test_sniffing_matches_reference():
    """The reference's key tests in its order, on each file's keys."""
    from forge_tpu.models.dat import is_dat
    from forge_tpu.models.hat import is_hat
    from forge_tpu.models.scunet import is_scunet
    from forge_tpu_torch.core.synth import synth_esrgan_sd
    from forge_tpu_torch.pipeline.upscalers import sniff_architecture

    want = {"hat": "HAT", "swinir": "SwinIR", "dat": "DAT", "scunet": "SCUNet"}
    for arch, name in want.items():
        sd = tiny_sd(arch)
        assert sniff_architecture(sd) == name
        assert is_hat(sd) == (name == "HAT") and is_dat(sd) == (name == "DAT")
        assert is_scunet(sd) == (name == "SCUNet")
    assert sniff_architecture(synth_esrgan_sd(num_feat=4, num_block=1, num_grow=2)) == "ESRGAN"


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """The port's and forge_tpu's model directories: the same tiny files,
    forge_tpu's HAT and DAT with their shuffle convs reordered."""
    base = tmp_path_factory.mktemp("models")
    files = {"HAT": ("hat", "hat_tiny"), "DAT": ("dat", "dat_tiny"),
             "ScuNET": ("scunet", "scunet_tiny"), "SwinIR": ("swinir", "swinir_tiny")}
    dirs = {}
    for kind, (arch, name) in files.items():
        sd = tiny_sd(arch, seed=7, **({"upsampler": "pixelshuffle", "scale": 2}
                                      if arch == "swinir" else {}))
        write(sd, str(base / "port" / kind / f"{name}.safetensors"))
        write(reference_sd(sd), str(base / "ref" / kind / f"{name}.safetensors"))
        dirs[kind] = name
    return base, dirs


@pytest.mark.parametrize("kind", ["HAT", "DAT", "ScuNET", "SwinIR"])
def test_registry_upscales_as_reference(model_dirs, kind):
    """Each file through both registries at ×2 in 32² tiles (overlap 4):
    uint8 within 1 of forge_tpu's. SCUNet runs at scale 1, then Lanczos."""
    from forge_tpu.pipeline.upscalers import UpscalerRegistry as JRegistry
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline.upscalers import UpscalerRegistry
    from forge_tpu_torch.runtime.options import opts

    base, names = model_dirs
    reg = UpscalerRegistry(model_dirs={kind: str(base / "port" / kind)}, device="cpu")
    jreg = JRegistry(model_dirs={kind: str(base / "ref" / kind)})
    img = np.random.default_rng(8).integers(0, 256, (40, 36, 3), dtype=np.uint8)
    tiles = {f"{k}_tile": 32 for k in ("ESRGAN", "SWIN", "DAT")}
    tiles.update({f"{k}_tile_overlap": 4 for k in ("ESRGAN", "SWIN", "DAT")})
    with opts.override(tiles), jopts.override(tiles):
        want = jreg.get(names[kind]).upscale(img, 2.0)
        got = reg.get(names[kind]).upscale(img, 2.0)
    assert got.shape == want.shape == (80, 72, 3)
    diff = np.abs(got.astype(np.int16) - want)
    assert diff.max() <= 1 and diff.mean() < 0.05, (diff.max(), diff.mean())
    assert got.std() > 3


def test_tile_options_follow_the_directory(model_dirs, monkeypatch):
    """The (tile, overlap) each registry hands `tiled_upscale` for a file in
    models/SwinIR, models/DAT, models/HAT and models/ScuNET under distinct
    options, and with every tile at 0 (→ 192) and overlap 0 (→ 1)."""
    from forge_tpu.pipeline import upscalers as jup
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import upscalers as tup
    from forge_tpu_torch.runtime.options import opts

    base, names = model_dirs
    seen = {"port": [], "ref": []}

    def recorder(side, real):
        def tiled(img, fn, scale, tile_size=192, overlap=8):
            seen[side].append((tile_size, overlap))
            return real(img, fn, scale, tile_size=tile_size, overlap=overlap)
        return tiled

    monkeypatch.setattr(tup, "tiled_upscale", recorder("port", tup.tiled_upscale))
    monkeypatch.setattr(jup, "tiled_upscale", recorder("ref", jup.tiled_upscale))
    img = np.random.default_rng(9).integers(0, 256, (16, 16, 3), dtype=np.uint8)
    settings = ({"ESRGAN_tile": 24, "ESRGAN_tile_overlap": 3, "SWIN_tile": 40,
                 "SWIN_tile_overlap": 5, "DAT_tile": 48, "DAT_tile_overlap": 6},
                {f"{k}{s}": 0 for k in ("ESRGAN", "SWIN", "DAT") for s in ("_tile", "_tile_overlap")})
    kinds = ("SwinIR", "DAT", "HAT", "ScuNET")
    regs = {kind: (tup.UpscalerRegistry(model_dirs={kind: str(base / "port" / kind)}, device="cpu"),
                   jup.UpscalerRegistry(model_dirs={kind: str(base / "ref" / kind)}))
            for kind in kinds}
    for values in settings:
        for kind in kinds:
            reg, jreg = regs[kind]
            with opts.override(values), jopts.override(values):
                reg.get(names[kind]).upscale(img, 1.0 if kind == "ScuNET" else 2.0)
                jreg.get(names[kind]).upscale(img, 1.0 if kind == "ScuNET" else 2.0)
    assert seen["port"] == seen["ref"] == [(40, 5), (48, 6), (24, 3), (24, 3)] + [(192, 1)] * 4


def test_scunet_upstream_table_refused():
    """upstream's constructor leaves relative_position_params [heads, 15, 15];
    the reference reads the last axis as the heads (15) and garbles the
    table, the port raises."""
    from forge_tpu.models.scunet import infer_scunet_meta as jmeta
    from forge_tpu_torch.models import scunet

    sd = tiny_sd("scunet")
    sd = {k: (np.ascontiguousarray(v.reshape(15, 15, -1).transpose(2, 0, 1))
              if k.endswith("relative_position_params") else v) for k, v in sd.items()}
    assert jmeta(reference_tree(sd))["head_dim"] == 4 // 15
    tree = port_tree(scunet.load_scunet(sd))
    with pytest.raises(ValueError, match="relative_position_params"):
        scunet.scunet_apply(tree, torch.zeros(1, 3, 8, 8), head_dim=2)
