"""preprocessors/cv2_np.py against cv2, the pure-CV registry entries against
forge_tpu's, and runtime/profiling.py against forge_tpu's (CPU).

cv2 runs with Intel IPP off (`cv2.ipp.setUseIPP(False)`): this cv2 hands
INTER_CUBIC on 1–4 channels to IPP's own kernel while IPP is on, which
rounds some pixels one level apart from OpenCV's code; cv2_np rebuilds
OpenCV's code. On uint8 every resize (nearest, area down and up, integer
area, cubic, Lanczos-4) at odd, upscaled and downscaled sizes, RGB→GRAY
and BGR→HSV over all 2^24 colours, BGR→LAB, the threshold (Otsu and
fixed), ellipse2Poly, fillConvexPoly, filled circles and lines of
thickness 1 and 2 (end points inside and far outside the image), the 5×5
GaussianBlur and the CV_32F Laplacian (aperture 1), both at odd sizes and
down to 1×1 where the reflected border wraps, equal cv2's byte for byte;
GaussianBlur on float32 at ksize (0, 0) is within 1e-6 of the largest
value. On float32 a resize is within 4e-6 of the largest
value: OpenCV's vector code fuses or reorders some products and sums; the
linear one (pipeline/images.py `cv2_linear_resize`) within 3e-5, as it
takes IPP's taps in float64 where OpenCV's own code rounds them to float32. The
eleven pure-CV entries equal forge_tpu's over their slider values. Timer's
records and summary, the NaN messages and the engine's NansException equal
forge_tpu's / are the same class.
"""

import torch_threads  # noqa: F401  (one torch thread a test process)
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
torch = pytest.importorskip("torch")

from forge_tpu_torch.preprocessors import cv2_np  # noqa: E402
from torch_annotator_cases import image  # noqa: E402

SIZES = [((37, 53), (24, 29)), ((64, 64), (48, 48)), ((50, 70), (103, 77)),
         ((512, 512), (384, 384)), ((40, 40), (518, 518)), ((33, 47), (8, 5)),
         ((30, 30), (90, 60)), ((64, 96), (32, 48)), ((90, 90), (30, 30)), ((46, 46), (128, 128))]
INTERP = {"nearest": cv2.INTER_NEAREST, "area": cv2.INTER_AREA, "cubic": cv2.INTER_CUBIC,
          "lanczos4": cv2.INTER_LANCZOS4, "linear": cv2.INTER_LINEAR}


@pytest.fixture(autouse=True)
def no_ipp():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


FILTER_SIZES = [(1, 1), (1, 7), (2, 3), (5, 4), (17, 31), (64, 65), (97, 128)]


@pytest.mark.parametrize("h,w", FILTER_SIZES)
def test_gaussian_blur_and_laplacian_on_uint8_match_cv2(h, w):
    rng = np.random.default_rng(h * 1000 + w)
    for shape in ((h, w), (h, w, 3)):
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(cv2_np.gaussian_blur(a, (5, 5), 0), cv2.GaussianBlur(a, (5, 5), 0))
    a = rng.integers(0, 256, (h, w), dtype=np.uint8)
    want = cv2.Laplacian(a, cv2.CV_32F)
    got = cv2_np.laplacian(a)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    edge = np.zeros((h, w), np.uint8)  # the border's reflection on a single bright row
    edge[0] = 255
    assert np.array_equal(cv2_np.laplacian(edge), cv2.Laplacian(edge, cv2.CV_32F))
    assert np.array_equal(cv2_np.gaussian_blur(edge, (5, 5), 0), cv2.GaussianBlur(edge, (5, 5), 0))


@pytest.mark.parametrize("h,w,sigma", [(2, 3, 1.0), (17, 31, 2.5), (64, 65, 4.0),
                                       (96, 128, 6.0), (33, 20, 1.3), (5, 200, 3.2)])
def test_gaussian_blur_float32_matches_cv2(h, w, sigma):
    a = np.random.default_rng(h + w).random((h, w)).astype(np.float32) * 3.0
    a[:, : w // 3] = 0.0  # a step to the border
    want = cv2.GaussianBlur(a, (0, 0), sigma)
    got = cv2_np.gaussian_blur(a, (0, 0), sigma)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_gaussian_blur_refuses_other_uint8_kernels():
    with pytest.raises(ValueError, match="ksize"):
        cv2_np.gaussian_blur(np.zeros((4, 4), np.uint8), (3, 3), 0)


@pytest.mark.parametrize("method", list(INTERP))
def test_resize_matches_cv2(method):
    rng = np.random.default_rng(list(INTERP).index(method))
    for (h, w), (oh, ow) in SIZES:
        for ch in (None, 3, 19):
            shape = (h, w) if ch is None else (h, w, ch)
            if ch != 19:
                u = rng.integers(0, 256, shape, dtype=np.uint8)
                want = cv2.resize(u, (ow, oh), interpolation=INTERP[method])
                got = cv2_np.resize(u, (ow, oh), INTERP[method])
                assert got.dtype == np.uint8 and np.array_equal(got, want), (shape, (oh, ow))
            if ch == 19 and method == "area" and (h % oh or w % ow):
                continue  # cv2 refuses INTER_AREA on more than 4 channels at a fractional ratio
            f = rng.standard_normal(shape).astype(np.float32)
            want = cv2.resize(f, (ow, oh), interpolation=INTERP[method])
            got = cv2_np.resize(f, (ow, oh), INTERP[method])
            assert got.dtype == np.float32 and got.shape == want.shape
            bound = 3e-5 if method == "linear" else 4e-6
            assert np.abs(got - want).max() <= bound * np.abs(want).max(), (shape, (oh, ow))


def test_resize_same_size_is_a_copy():
    u = np.random.default_rng(0).integers(0, 256, (10, 12, 3), dtype=np.uint8)
    got = cv2_np.resize(u, (12, 10), cv2_np.INTER_CUBIC)
    assert got is not u and np.array_equal(got, u)


def test_colour_conversions_match_cv2():
    grid = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256), indexing="ij"),
                    -1).reshape(4096, 4096, 3).astype(np.uint8)
    assert np.array_equal(cv2_np.rgb_to_gray(grid), cv2.cvtColor(grid, cv2.COLOR_RGB2GRAY))
    assert np.array_equal(cv2_np.bgr_to_hsv(grid), cv2.cvtColor(grid, cv2.COLOR_BGR2HSV))
    u = image(0, 67, 91)
    assert np.array_equal(cv2_np.bgr_to_lab(u), cv2.cvtColor(u, cv2.COLOR_BGR2LAB))


def test_threshold_matches_cv2():
    rng = np.random.default_rng(1)
    g = cv2.cvtColor(image(1, 40, 50), cv2.COLOR_RGB2GRAY)
    for t in (-3, 0, 1, 50, 127.5, 254, 255, 300):
        want = cv2.threshold(g, t, 255, cv2.THRESH_BINARY_INV)
        got = cv2_np.threshold(g, t, 255, cv2_np.THRESH_BINARY_INV)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
    for s in range(12):
        gg = (rng.integers(0, 256, (40, 50), dtype=np.uint8) if s % 2 else
              np.clip(rng.normal(100 + 5 * s, 30, (40, 50)), 0, 255).astype(np.uint8))
        want = cv2.threshold(gg, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
        got = cv2_np.threshold(gg, 0, 255, cv2_np.THRESH_BINARY_INV + cv2_np.THRESH_OTSU)
        assert got[0] == want[0] and np.array_equal(got[1], want[1])


def test_ellipse_polygons_and_fills_match_cv2():
    rng = np.random.default_rng(2)
    for n in range(600):
        c = (int(rng.integers(-20, 140)), int(rng.integers(-20, 120)))
        axes = (int(rng.integers(0, 80)), int(rng.integers(0, 10)))
        angle = int(rng.integers(-400, 400))
        arc = (0, 360) if n % 3 else (int(rng.integers(-100, 300)), int(rng.integers(-100, 400)))
        delta = int(rng.choice([1, 1, 5, 10]))
        poly = cv2.ellipse2Poly(c, axes, angle, arc[0], arc[1], delta)
        assert np.array_equal(cv2_np.ellipse2poly(c, axes, angle, arc[0], arc[1], delta), poly)
        got, want = np.zeros((100, 120, 3), np.uint8), np.zeros((100, 120, 3), np.uint8)
        cv2_np.fill_convex_poly(got, poly, [153, 51, 0])
        cv2.fillConvexPoly(want, poly, [153, 51, 0])
        assert np.array_equal(got, want)


def test_circles_and_lines_match_cv2():
    rng = np.random.default_rng(3)
    for n in range(400):
        got, want = np.zeros((100, 120, 3), np.uint8), np.zeros((100, 120, 3), np.uint8)
        c, r = (int(rng.integers(-10, 130)), int(rng.integers(-10, 110))), int(rng.integers(0, 9))
        cv2_np.circle(got, c, r, (255, 0, 0), thickness=-1)
        cv2.circle(want, c, r, (255, 0, 0), thickness=-1)
        assert np.array_equal(got, want)
        for thickness in (1, 2):
            far = n % 2
            p1 = tuple(int(v) for v in (rng.integers(-300, 400, 2) if far else
                                         (rng.integers(0, 120), rng.integers(0, 100))))
            p2 = tuple(int(v) for v in (rng.integers(0, 120), rng.integers(0, 100)))
            got, want = np.zeros((100, 120), np.uint8), np.zeros((100, 120), np.uint8)
            cv2_np.line(got, p1, p2, 255, thickness)
            cv2.line(want, p1, p2, 255, thickness)
            assert np.array_equal(got, want), (p1, p2, thickness)


CV_ENTRIES = {"invert": [0], "blur_gaussian": [0, 2.5], "shuffle": [0],
              "lineart_standard": [0, 3.0], "scribble_xdog": [0, 16], "threshold": [0, 100],
              "tile_resample": [0, 2.0, 3.5], "recolor_luminance": [0, 0.5, 1.7],
              "recolor_intensity": [0, 0.5], "t2ia_color_grid": [0],
              "threshold_binary": [0, 100, 255]}


@pytest.mark.parametrize("name", list(CV_ENTRIES))
def test_pure_cv_entries_match_reference(name):
    import forge_tpu.preprocessors as ref
    import forge_tpu_torch.preprocessors as port

    assert port.PREPROCESSORS[name].ported
    for img in (image(4, 83, 117), np.random.default_rng(5).integers(0, 256, (70, 64, 3),
                                                                        dtype=np.uint8)):
        for a in CV_ENTRIES[name]:
            for res in (64, 200):
                want = ref.PREPROCESSORS[name](img, res, a, 0)
                got = port.PREPROCESSORS[name](img, res, a, 0)
                assert got.dtype == want.dtype and np.array_equal(got, want), (a, res)


def test_timer_and_nan_guard_match_reference(monkeypatch):
    from forge_tpu.runtime import profiling as ref
    from forge_tpu_torch.pipeline import engine
    from forge_tpu_torch.runtime import profiling

    clock = iter(np.arange(0.0, 100.0, 0.25))
    for mod in (ref, profiling):
        monkeypatch.setattr(mod.time, "time", lambda: float(next(clock)))
    timers = []
    for mod in (ref, profiling):
        clock = iter(np.arange(0.0, 100.0, 0.25))
        t = mod.Timer("load")
        t.record("a")
        with t.subcategory("b"):
            t.record("c")
            t.record("c")
        t.record("a")
        timers.append(t)
    assert timers[0].records == timers[1].records and timers[0].summary() == timers[1].summary()
    assert engine.NansException is profiling.NansException
    assert engine.raise_nans is profiling.raise_nans
    for where in ("unet", "vae", "the refiner"):
        with pytest.raises(ref.NansException) as want:
            ref.raise_nans(where)
        with pytest.raises(engine.NansException) as got:
            profiling.test_for_nans(torch.tensor([1.0, float("nan")]), where)
        assert str(got.value) == str(want.value)
    profiling.test_for_nans(torch.tensor([1.0, float("inf")]), "unet", enabled=False)
    profiling.test_for_nans(np.ones(3), "unet")
    with pytest.raises(profiling.NansException):
        profiling.test_for_nans(np.array([np.inf]), "vae")


def test_trace_and_memory_monitor_on_the_cpu(tmp_path):
    from forge_tpu_torch.runtime import profiling

    with profiling.trace(str(tmp_path / "traces"), name="cpu") as result:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert result.path and (tmp_path / "traces").is_dir() and result.path.endswith(".json")
    assert result.wall_s > 0 and result.device_s == 0 and result.busy == 0
    with profiling.trace(enabled=False) as off:
        pass
    assert off.path is None
    mon = profiling.MemoryMonitor(interval=0.01, device="cpu")
    mon.start()
    assert mon.stop() == {"baseline": 0, "peak": 0}


def test_trace_without_a_directory_writes_no_file(tmp_path, monkeypatch):
    from forge_tpu_torch.runtime import profiling

    monkeypatch.chdir(tmp_path)
    with profiling.trace(logdir=None, name="cpu") as result:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert result.path is None and not list(tmp_path.iterdir())
    assert result.wall_s > 0 and result.kernels == {} and result.device_events == 0
