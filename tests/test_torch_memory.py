"""The port's memory plan and tiled VAE against forge_tpu (CPU, f32).

`plan_generation` gives forge_tpu's `Plan` over a grid of batch, size,
weight bytes and free bytes (the "assume 16 GiB" branch included);
`device_memory` reads zeros on the CPU, as forge_tpu's does without
statistics. The tiled decode and encode of the tiny SD1.5 VAE
(tests/fixtures.py `make_sd15_checkpoint(0)`) match forge_tpu's within 1e-4
of the largest value, at tiles small enough for 12 tiles with a clamped last
row and column. `process_images` under `vae_always_tiled` (the tiles made
small on both engines) matches forge_tpu's image (PSNR ≥ 40 dB), reports the
tiled decode, and serving gives its bytes; a chunked plan keeps the seeds'
layout.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

GIB = 1 << 30
REQUEST = dict(prompt="a cat", negative_prompt="blurry", seed=3, steps=2, width=64, height=48,
               sampler_name="Euler", cfg_scale=7.0)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _small_tiles(eng):
    """Decode tiles of 4 latent pixels at overlap 1, encode tiles of 32 pixels at overlap 8."""
    eng.decode_first_stage_tiled = functools.partial(eng.decode_first_stage_tiled,
                                                     tile=4, overlap=1)
    eng.encode_first_stage_tiled = functools.partial(eng.encode_first_stage_tiled,
                                                     tile=32, overlap=8)
    return eng


@pytest.fixture(scope="module")
def engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    return make_tiny_engine(0), teng


@pytest.mark.parametrize("batch", [1, 2, 3, 8])
def test_plans_match_forge_tpu(batch):
    from forge_tpu.runtime import memory as jmem
    from forge_tpu_torch.runtime import memory as tmem

    for size in ((512, 512), (1024, 1024), (2048, 2048), (768, 1344)):
        for weight in (0, 2 * GIB, 5 * GIB, 12 * GIB):
            for free in (0, GIB // 2, 3 * GIB, 10 * GIB, 70 * GIB):
                want = jmem.plan_generation(batch, *size, weight_bytes=weight, free_bytes=free)
                got = tmem.plan_generation(batch, *size, weight_bytes=weight, free_bytes=free)
                assert (got.batch_chunk, got.tiled_vae, got.note) == (
                    want.batch_chunk, want.tiled_vae, want.note), (batch, size, weight, free)
    assert tmem.unet_activation_bytes(2, 1024, 1024) == jmem.unet_activation_bytes(2, 1024, 1024)
    assert tmem.vae_decode_bytes(256, 256) == jmem.vae_decode_bytes(256, 256)


def test_device_memory_and_tree_bytes(engines):
    from forge_tpu.pipeline.processing import _tree_bytes
    from forge_tpu_torch.runtime.memory import device_memory, plan_generation, tree_bytes

    jeng, teng = engines
    assert device_memory("cpu") == {"total": 0, "used": 0, "free": 0}
    assert tree_bytes(teng.loaded.unet) == _tree_bytes(jeng.loaded.unet) > 0
    # no statistics on the CPU: 16 GiB less the weights, as the reference assumes
    got = plan_generation(2, 2048, 2048, weight_bytes=14 * GIB, device="cpu")
    assert (got.batch_chunk, got.tiled_vae) == (1, True)


def test_tiled_decode_matches_forge_tpu(engines):
    jeng, teng = engines
    lat = np.random.default_rng(0).standard_normal((1, 8, 11, 4)).astype(np.float32)
    # stride 3: rows at 0, 3 and 4 (clamped), columns at 0, 3, 6 and 7 (clamped)
    assert list(teng._tiles(8, 11, 4, 1)) == [(t, l, t + 4, l + 4) for t in (0, 3, 4)
                                            for l in (0, 3, 6, 7)]
    want = np.asarray(jeng.decode_first_stage_tiled(jnp.asarray(lat), tile=4, overlap=1))
    got = teng.decode_first_stage_tiled(torch.from_numpy(lat.transpose(0, 3, 1, 2)), tile=4,
                                        overlap=1)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 64, 88, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    whole = teng.decode_first_stage(torch.from_numpy(lat.transpose(0, 3, 1, 2)))
    assert not torch.allclose(whole, torch.from_numpy(got).permute(0, 3, 1, 2), atol=1e-3)


def test_tiled_encode_matches_forge_tpu(engines):
    jeng, teng = engines
    img = np.random.default_rng(1).uniform(-1, 1, (1, 64, 88, 3)).astype(np.float32)
    want = np.asarray(jeng.encode_first_stage_tiled(jnp.asarray(img), tile=32, overlap=8))
    got = teng.encode_first_stage_tiled(torch.from_numpy(img.transpose(0, 3, 1, 2)), tile=32,
                                        overlap=8)
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (1, 8, 11, 4)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_vae_always_tiled_matches_forge_tpu(engines):
    """The option forces the plan's tiled VAE: the decode runs in tiles
    (`decode_method`), as forge_tpu's does, and serving gives the same bytes."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts
    from forge_tpu_torch.runtime.serving import ServingPipeline

    jeng, teng = engines
    jeng, teng = _small_tiles(jeng), _small_tiles(teng)
    try:
        with jopts.override({"vae_always_tiled": True}):
            want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
        opts.set("vae_always_tiled", True)  # set, not overridden: serving's threads read it too
        res = tproc.process_images(teng, tproc.Processing(**REQUEST))
        with ServingPipeline(teng) as pipe:
            served = pipe.submit(tproc.Processing(**REQUEST)).result()["images"][0]
        opts.set("vae_always_tiled", False)
        whole = tproc.process_images(teng, tproc.Processing(**REQUEST))
    finally:
        opts.set("vae_always_tiled", False)
        for eng in (jeng, teng):
            del eng.decode_first_stage_tiled, eng.encode_first_stage_tiled
    got = res.images[0]
    assert res.decode_method == "tiled" and whole.decode_method == "full"
    assert got.shape == want.shape == (48, 64, 3)
    assert _psnr(got, want) >= 40.0, _psnr(got, want)
    assert np.array_equal(served, got)
    assert not np.array_equal(whole.images[0], got)


def test_chunked_plan_keeps_the_seed_layout(engines, monkeypatch):
    """A plan that chunks batch 4 to 3 runs two batches of 2 (the chunk
    divides the batch), with the seeds of one batch of 4."""
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.memory import Plan

    teng = engines[1]
    monkeypatch.setattr(tproc, "plan_generation",
                        lambda *a, **k: Plan(batch_chunk=3, tiled_vae=False, note="chunked"))
    p = tproc.Processing(**dict(REQUEST, batch_size=4))
    tproc.setup(teng, p)
    pl = tproc.plan(teng, p)
    assert (pl.batch_chunk, p.batch_size, p.n_iter, p._plan is pl) == (3, 2, 2, True)
    assert p.all_seeds == [3, 4, 5, 6]
    q = tproc.Processing(**dict(REQUEST, batch_size=4))
    tproc.setup(teng, q)
    tproc.plan(teng, q, chunk=False)
    assert (q.batch_size, q.n_iter) == (4, 1)
