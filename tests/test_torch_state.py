"""The port's job state, work queue, previews, TAESD, interrupt and PNG codec
against forge_tpu (CPU, f32).

`State` (progress, eta, snapshot, interrupt, the preview's PNG) and the
`WorkQueue` (order, results, errors) behave as forge_tpu's. The previews
(`latent_to_rgb_cheap`), TAESD's decoder and encoder and VAEApprox match
forge_tpu's within 1e-5 on synthetic weights (core/synth.py `synth_taesd_sd`,
the `.pth` layout), through `params_from_jax` too. On the tiny SD1.5
(tests/fixtures.py `make_sd15_checkpoint(0)`, 32², Euler a, 4 steps, CFG 7):
an interrupt after step 2 gives forge_tpu's image under
`interrupt_poll_steps = 2` (PSNR ≥ 40 dB), and `sd_vae_decode_method`
"TAESD" forge_tpu's TAESD image from the same file. Three faults of the
reference the port does not inherit are shown from both sides: its preview
tick takes SD1.5's factors on SDXL, previews every step at
`show_progress_every_n_steps` -1, and never reads `/skip`'s flag. The PNG
codec is held both ways against Pillow, each of the five row filters on
its own rows too, and refuses what Pillow refuses as decompression bombs.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import io
import struct
import threading
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from PIL import Image, PngImagePlugin  # noqa: E402

from fixtures import CLIP_HEADS, CLIP_WIDTH, make_sd15_checkpoint, make_tiny_engine  # noqa: E402

REQUEST = dict(prompt="a cat", negative_prompt="blurry", seed=7, steps=4, width=32, height=32,
               sampler_name="Euler a", cfg_scale=7.0)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def engines():
    from forge_tpu_torch.models.unet import UNetConfig
    from forge_tpu_torch.pipeline.engine import load_engine

    teng = load_engine(make_sd15_checkpoint(0), device="cpu")
    teng.unet_cfg = UNetConfig(context_dim=CLIP_WIDTH, num_heads=CLIP_HEADS)
    return make_tiny_engine(0), teng


@pytest.fixture
def states():
    from forge_tpu.runtime.state import state as jstate
    from forge_tpu_torch.runtime.state import state

    jstate.reset()
    state.reset()
    yield jstate, state
    jstate.reset()
    state.reset()


def _jax_tree(sd):
    from forge_tpu.core.state_dict import transform_for_jax
    from forge_tpu.core.tree import nest

    return nest({k: jnp.asarray(v) for k, v in transform_for_jax(sd).items()})


def _port_tree(sd):
    from forge_tpu_torch.core.convert import nest

    return nest({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})


def test_state_matches_forge_tpu():
    from forge_tpu.runtime.state import State as JState
    from forge_tpu_torch.runtime.state import State

    ours, ref = State(), JState()
    for st in (ours, ref):
        assert st.progress() == 0.0 and st.eta() is None
        st.begin("txt2img", job_count=2, steps=10)
    for n in (1, 3, 6, 12, 25):
        for st in (ours, ref):
            st.sampling_step = n
            st.job_no = n // 10
        assert ours.progress() == ref.progress()
        assert {k: v for k, v in ours.snapshot().items() if k != "job_timestamp"} == {
            k: v for k, v in ref.snapshot().items() if k != "job_timestamp"}
        assert ours.eta() is not None and ours.eta() >= 0 and ref.eta() >= 0
    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    for st in (ours, ref):
        st.set_current_image(img)
        st.interrupt()
        with pytest.raises(InterruptedError):
            st.step()
        st.skip()
        st.end()
    assert ours.snapshot()["interrupted"] and ours.snapshot()["skipped"] and ours.job == ""
    assert ours.current_image_sampling_step == ref.current_image_sampling_step == 25
    assert ours.sampling_step == ref.sampling_step == 26
    import base64

    pixels = [np.asarray(Image.open(io.BytesIO(base64.b64decode(st.current_image_base64()))))
              for st in (ours, ref)]
    assert np.array_equal(pixels[0], img) and np.array_equal(pixels[1], img)


def test_work_queue_matches_forge_tpu():
    from forge_tpu.runtime.queue import WorkQueue as JQueue
    from forge_tpu_torch.runtime.queue import WorkQueue

    results = []
    for cls in (WorkQueue, JQueue):
        q, order, threads = cls(), [], set()

        def job(i):
            order.append(i)
            threads.add(threading.get_ident())
            return i * i

        tasks = [q.submit(job, i) for i in range(6)]
        values = [t.wait(30) for t in tasks]
        with pytest.raises(ZeroDivisionError, match="division by zero"):
            q.run_and_wait(lambda: 1 / 0)
        assert q.run_and_wait(lambda a, b=0: a + b, 2, b=3) == 5
        q.stop()
        results.append((order, values, len(threads)))
    assert results[0] == results[1] == (list(range(6)), [i * i for i in range(6)], 1)


@pytest.mark.parametrize("family", ["sd15", "sdxl"])
def test_latent_to_rgb_cheap_matches_forge_tpu(family):
    from forge_tpu.pipeline.preview import latent_to_rgb_cheap as jcheap
    from forge_tpu_torch.pipeline.preview import latent_to_rgb_cheap

    lat = np.random.default_rng(2).standard_normal((2, 4, 6, 5)).astype(np.float32)
    want = jcheap(lat.transpose(0, 2, 3, 1), family)
    assert np.array_equal(latent_to_rgb_cheap(torch.from_numpy(lat), family), want)
    assert np.array_equal(latent_to_rgb_cheap(lat, family), want)


def test_taesd_and_vae_approx_match_forge_tpu():
    from forge_tpu.pipeline import taesd as jt
    from forge_tpu_torch.core.convert import nest, params_from_jax
    from forge_tpu_torch.core.synth import synth_taesd_sd
    from forge_tpu_torch.pipeline import taesd as tt

    rng = np.random.default_rng(3)
    sd = synth_taesd_sd(fill="random", seed=3)
    jp, tp = _jax_tree(sd), _port_tree(sd)
    lat = rng.standard_normal((2, 4, 8, 6)).astype(np.float32) * 3
    want = np.asarray(jt.taesd_decode(jp, jnp.asarray(lat.transpose(0, 2, 3, 1))))
    got = tt.taesd_decode(tp, torch.from_numpy(lat)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 64, 48, 3) and want.std() > 0.01
    assert np.abs(got - want).max() <= 1e-5
    converted = tt.taesd_decode(nest(params_from_jax(jp)), torch.from_numpy(lat))
    assert torch.equal(converted, tt.taesd_decode(tp, torch.from_numpy(lat)))

    img = rng.uniform(0, 1, (1, 32, 40, 3)).astype(np.float32)
    want = np.asarray(jt.taesd_encode(jp, jnp.asarray(img)))
    got = tt.taesd_encode(tp, torch.from_numpy(img.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (1, 4, 5, 4)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    widths = [(4, 8, 7), (8, 16, 5), (16, 32, 3), (32, 64, 3), (64, 32, 3), (32, 16, 3),
              (16, 8, 3), (8, 3, 3)]  # VAEApprox's eight convs (sd_vae_approx.py:10-21)
    approx = {}
    for i, (c_in, c_out, k) in enumerate(widths, 1):
        approx[f"conv{i}.weight"] = (rng.standard_normal((c_out, c_in, k, k))
                                     / np.sqrt(c_in * k * k)).astype(np.float32)
        approx[f"conv{i}.bias"] = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
    want = np.asarray(jt.vae_approx_decode(_jax_tree(approx),
                                           jnp.asarray(lat.transpose(0, 2, 3, 1))))
    got = tt.vae_approx_decode(_port_tree(approx), torch.from_numpy(lat))
    assert torch.equal(got, tt.vae_approx_decode(nest(params_from_jax(_jax_tree(approx))),
                                                 torch.from_numpy(lat)))
    got = got.permute(0, 2, 3, 1)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_taesd_register_replaces_device_copies(monkeypatch):
    """Weights registered anew replace the device copies `load_taesd` made of
    the old ones."""
    from forge_tpu_torch.core.synth import synth_taesd_sd
    from forge_tpu_torch.pipeline import taesd as tt

    monkeypatch.setattr(tt, "_cache", {})
    leaves = []
    for seed in (1, 2):
        tt.register_taesd("taesdxl", "decoder", synth_taesd_sd(fill="random", seed=seed))
        leaves.append(tt.taesd_for_family("sdxl", device="cpu")["decoder"]["1"]["weight"])
    assert not torch.equal(*leaves)
    assert torch.equal(leaves[1], tt._cache[("taesdxl", "decoder")]["decoder"]["1"]["weight"])


def test_preview_tick_takes_the_engines_family(states):
    """Reference-side fault: forge_tpu's `_progress_tick` calls
    `latent_to_rgb_cheap(np.asarray(x0))` without the family
    (forge_tpu/pipeline/processing.py:392), so an SDXL preview takes SD1.5's
    factors. The port's tick passes the engine's family."""
    import types

    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.pipeline.preview import latent_to_rgb_cheap as jcheap
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    jstate, state = states
    x0 = np.random.default_rng(4).standard_normal((1, 4, 6, 6)).astype(np.float32)
    nhwc = x0.transpose(0, 2, 3, 1)
    sdxl = types.SimpleNamespace(family="sdxl")
    jproc._PREVIEW_ENGINE = sdxl
    jstate.begin("txt2img", steps=1)
    with jopts.override({"show_progress_every_n_steps": 1}):
        jproc._progress_tick(nhwc)
    assert np.array_equal(jstate.current_image, jcheap(nhwc, "sd15")[0])
    state.begin("txt2img", steps=1)
    with opts.override({"show_progress_every_n_steps": 1}):
        tproc._progress_tick(sdxl, torch.from_numpy(x0))
    assert np.array_equal(state.current_image, jcheap(nhwc, "sdxl")[0])
    assert not np.array_equal(jcheap(nhwc, "sd15"), jcheap(nhwc, "sdxl"))


def test_preview_period_minus_one_means_none(states):
    """Reference-side fault: forge_tpu's option reads "-1 = off", but its tick
    takes max(-1, 1) and previews at every step. The port makes none."""
    import types

    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    jstate, state = states
    x0 = np.zeros((1, 4, 4, 4), np.float32)
    eng = types.SimpleNamespace(family="sd15")
    jproc._PREVIEW_ENGINE = eng
    jstate.begin("txt2img", steps=3)
    state.begin("txt2img", steps=3)
    with jopts.override({"show_progress_every_n_steps": -1}):
        jproc._progress_tick(x0.transpose(0, 2, 3, 1))
    with opts.override({"show_progress_every_n_steps": -1}):
        tproc._progress_tick(eng, torch.from_numpy(x0))
    assert jstate.current_image is not None and jstate.sampling_step == 1
    assert state.current_image is None and state.sampling_step == 1


def test_interrupt_after_step_k_matches_forge_tpu(engines, states, monkeypatch):
    """An interrupt that lands after step 2 of 4 stops the port's loop at
    that step boundary and decodes the partial latent: forge_tpu's image
    under `interrupt_poll_steps = 2` with its state interrupted. Off a job
    (no `state.begin`), a standing flag stops nothing."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    (jeng, teng), (jstate, state) = engines, states
    jstate.interrupted = True
    with jopts.override({"interrupt_poll_steps": 2}):
        want = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]

    shown = []

    def interrupt_on_preview(img):  # the preview at step 2 is where the interrupt lands
        shown.append(state.sampling_step)
        state.interrupt()

    monkeypatch.setattr(state, "set_current_image", interrupt_on_preview)
    state.begin("txt2img", steps=4)
    with opts.override({"show_progress_every_n_steps": 2, "save_write_params_txt": False}):
        res = tproc.process_images(teng, tproc.Processing(**REQUEST))
    state.end()
    got = res.images[0]
    assert shown == [2] and state.sampling_step == 2 and state.interrupted
    assert _psnr(got, want) >= 40.0, _psnr(got, want)

    with opts.override({"save_write_params_txt": False}):  # no job: the flag stops nothing
        full = tproc.process_images(teng, tproc.Processing(**REQUEST)).images[0]
    assert state.sampling_step == 6 and not np.array_equal(full, got)


def test_skip_ends_the_batch(engines, states):
    """Reference-side fault: forge_tpu's `/skip` sets a flag its pipeline
    never reads, even split into polled phases: the image is the full run's.
    The port's skip ends the current batch at the next step boundary and goes
    on with the next batch."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.runtime.options import opts

    (jeng, teng), (jstate, state) = engines, states
    with jopts.override({"interrupt_poll_steps": 2}):  # the interrupt test's first phase, cached
        full = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
        jstate.skipped = True
        skipped = jproc.process_images(jeng, jproc.Processing(**REQUEST)).images[0]
    assert np.array_equal(skipped, full)

    request = dict(REQUEST, steps=2, n_iter=2)
    with opts.override({"save_write_params_txt": False}):
        two = tproc.process_images(teng, tproc.Processing(**request)).images
        state.begin("txt2img", job_count=2, steps=2)
        state.skip()
        res = tproc.process_images(teng, tproc.Processing(**request))
    assert state.sampling_step == 2 and not state.skipped
    assert not np.array_equal(res.images[0], two[0]) and np.array_equal(res.images[1], two[1])


def test_taesd_decode_method_matches_forge_tpu(engines, states, tmp_path, monkeypatch):
    """`sd_vae_decode_method` "TAESD" decodes with the family's TAESD file in
    models/VAE-taesd, as forge_tpu does; without a file both take the full
    VAE, and the port says so in `Processed.decode_method`. A "TAESD" live
    preview is the full-size TAESD image."""
    from forge_tpu.pipeline import processing as jproc
    from forge_tpu.pipeline import taesd as jt
    from forge_tpu.runtime.options import opts as jopts
    from forge_tpu_torch.core.save import save_safetensors
    from forge_tpu_torch.core.synth import synth_taesd_sd
    from forge_tpu_torch.pipeline import processing as tproc
    from forge_tpu_torch.pipeline import taesd as tt
    from forge_tpu_torch.runtime.options import opts

    (jeng, teng), (_, state) = engines, states
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(jt, "_cache", {})
    monkeypatch.setattr(tt, "_cache", {})
    request = REQUEST
    with opts.override({"sd_vae_decode_method": "TAESD", "save_write_params_txt": False}):
        missing = tproc.process_images(teng, tproc.Processing(**request))
    assert missing.decode_method == "full (no TAESD weights for sd15)"

    (tmp_path / "models" / "VAE-taesd").mkdir(parents=True)
    sd = synth_taesd_sd(fill="random", seed=5)
    save_safetensors({k: v for k, v in sd.items() if k.startswith("decoder.")},
                     str(tmp_path / "models" / "VAE-taesd" / "taesd_decoder.safetensors"))
    # forge_tpu's loop in the two phases the tests above compiled (Euler a carries no history)
    with jopts.override({"sd_vae_decode_method": "TAESD", "interrupt_poll_steps": 2}):
        want = jproc.process_images(jeng, jproc.Processing(**request)).images[0]
    state.begin("txt2img", steps=4)
    with opts.override({"sd_vae_decode_method": "TAESD", "save_write_params_txt": False,
                        "show_progress_every_n_steps": 1, "show_progress_type": "TAESD"}):
        res = tproc.process_images(teng, tproc.Processing(**request))
    got = res.images[0]
    assert res.decode_method == "TAESD"
    assert got.shape == want.shape == (32, 32, 3)
    assert _psnr(got, want) >= 40.0, _psnr(got, want)
    assert not np.array_equal(got, missing.images[0])
    assert state.current_image.shape == (32, 32, 3)


def _pillow_png(mode: str, optimize: bool) -> bytes:
    y, x = np.mgrid[0:37, 0:45]
    rgb = np.stack([(x * 5) % 256, (y * 6) % 256, ((x + y) * 3) % 256], -1).astype(np.uint8)
    im = Image.fromarray(rgb)
    alpha = Image.fromarray(((x * y) % 256).astype(np.uint8))
    if mode == "LA":
        im = im.convert("L")
        im.putalpha(alpha)
    elif mode == "RGBA":
        im.putalpha(alpha)
    elif mode == "P":
        im = im.quantize(7)  # 7 colours: Pillow writes 4 bits a pixel when optimising
    else:
        im = im.convert(mode)
    info = PngImagePlugin.PngInfo()
    info.add_text("parameters", "a cat\nSteps: 3, Seed: 1")
    info.add_text("comment", "z" * 80, zip=True)
    info.add_itxt("title", "ünïcødé")
    buf = io.BytesIO()
    im.save(buf, "PNG", optimize=optimize, pnginfo=info)
    return buf.getvalue()


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1"])
def test_png_reader_reads_pillow(mode):
    """Pillow-written PNGs (plain and optimised: other row filters, fewer
    bits a pixel) read with Pillow's pixels (as convert("RGB")) and text."""
    from forge_tpu_torch.pipeline.images import decode_png, to_rgb

    for optimize in (False, True):
        data = _pillow_png(mode, optimize)
        pixels, text = decode_png(data)
        want = Image.open(io.BytesIO(data))
        assert np.array_equal(to_rgb(pixels), np.asarray(want.convert("RGB")))
        assert text == {k: want.info[k] for k in ("parameters", "comment", "title")}


def test_png_writer_reads_in_pillow():
    """Port-written PNGs (gray, RGB, RGBA; a Latin-1 and a UTF-8 infotext)
    read back in Pillow with the same pixels and text; a JPEG, a 16-bit and
    an interlaced PNG are refused by name."""
    from forge_tpu_torch.pipeline.images import UnsupportedImage, decode_png, encode_png

    rng = np.random.default_rng(6)
    for shape in ((19, 23), (19, 23, 3), (19, 23, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        for text in ("a cat\nSteps: 3, Seed: 1", "ünïcødé ✓"):
            data = encode_png(img, {"parameters": text})
            back = Image.open(io.BytesIO(data))
            assert np.array_equal(np.asarray(back), img) and back.info["parameters"] == text
            assert np.array_equal(decode_png(data)[0], img)
    images = {}
    for name, mode in (("JPEG", "RGB"), ("16-bit PNG", "I;16")):
        buf = io.BytesIO()
        Image.new(mode, (8, 8)).save(buf, "JPEG" if name == "JPEG" else "PNG")
        images[name] = buf.getvalue()
    # Pillow writes no Adam7 PNG: set the interlace byte of a written one's IHDR
    data = bytearray(encode_png(np.zeros((8, 8, 3), np.uint8)))
    data[28] = 1
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    images["interlaced PNG"] = bytes(data)
    assert Image.open(io.BytesIO(images["interlaced PNG"])).info.get("interlace") == 1
    for name, data in images.items():
        with pytest.raises(UnsupportedImage) as err:
            decode_png(data)
        assert err.value.format == name


def _png(w, h, ctype, idat, extra=b""):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + extra + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _filter_rows(img, kinds):
    """uint8 [H,W,C] → the PNG scanlines of each row under its filter in
    `kinds` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), as the PNG
    specification's section 9.2 defines them."""
    h, w, bpp = img.shape
    x = img.reshape(h, w * bpp).astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[:, bpp:] = b[:, :-bpp]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[kinds, np.arange(h)]
    rows = np.concatenate([np.asarray(kinds)[:, None], (x - pred) & 255], 1)
    return rows.astype(np.uint8).tobytes()


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_undoes_each_row_filter(channels):
    """Rows filtered None, Sub and Up in turn, all five in turn, Average and
    Paeth in turn, and Paeth alone read as Pillow reads them."""
    from forge_tpu_torch.pipeline.images import decode_png

    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 31, channels), dtype=np.uint8)
    img[5:12] = img[5:12, :1]  # runs of equal pixels: Paeth's ties
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]
    for kinds in (np.arange(23) % 3, np.arange(23) % 5, 3 + np.arange(23) % 2, np.full(23, 4)):
        data = _png(31, 23, ctype, zlib.compress(_filter_rows(img, kinds)))
        want = np.asarray(Image.open(io.BytesIO(data)))
        assert np.array_equal(want.reshape(img.shape), img)
        assert np.array_equal(decode_png(data)[0].reshape(img.shape), img)


def test_png_reader_refuses_bombs():
    """Past Pillow's MAX_IMAGE_PIXELS (or 16384 a side) a PNG is refused
    before its data inflates; a zTXt text inflating past 1 MiB is refused;
    image data longer than the rows is read no further than the rows."""
    from forge_tpu_torch.pipeline.images import MAX_IMAGE_PIXELS, ImageTooLarge, decode_png

    assert MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    for w, h in ((20000, 20000), (16385, 1)):
        with pytest.raises(ImageTooLarge):
            decode_png(_png(w, h, 2, b"not zlib"))
    with pytest.raises(ValueError, match="holds none"):
        decode_png(_png(0, 8, 2, b"not zlib"))
    ztxt = b"comment\0\0" + zlib.compress(b"z" * ((1 << 20) + 1))
    chunk = (struct.pack(">I", len(ztxt)) + b"zTXt" + ztxt
             + struct.pack(">I", zlib.crc32(b"zTXt" + ztxt)))
    with pytest.raises(ImageTooLarge):
        decode_png(_png(1, 1, 0, zlib.compress(b"\0\0"), chunk))
    rows = _filter_rows(np.full((4, 4, 3), 9, np.uint8), np.zeros(4, int))
    long = zlib.compress(rows + bytes(1 << 24))
    pixels, _ = decode_png(_png(4, 4, 2, long))
    assert np.array_equal(pixels, np.full((4, 4, 3), 9, np.uint8))
