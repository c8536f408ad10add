# Copied from forge_tpu/runtime/profiling.py (Timer, MemoryMonitor, the NaN guard and its messages); the trace runs on torch.profiler and the memory monitor on torch.cuda.
"""Tracing, timing, device memory and the NaN guard.

  * `trace`: a torch.profiler window, written as a Chrome trace (open it in
    chrome://tracing or Perfetto) unless no directory is given, which also
    reports the card's busy share of the window (the summed duration of the
    device's kernels and copies over the window's wall time) and the device
    time by kernel name. Only the card is traced where there is one, so
    that the profiler's host overhead stays out of the window.
  * `Timer`: the hierarchical phase timer (reference modules/timer.py).
  * `MemoryMonitor`: the device's allocated bytes at the start of a job and
    their peak (reference memmon.py), from `torch.cuda.max_memory_allocated`.
  * `raise_nans`, `NansException`: the actionable NaN messages (reference
    devices.test_for_nans), raised by pipeline/engine.py's decode, whose
    finiteness flags are computed on the card with the decode and read with
    its images. `test_for_nans` is the reference's one-tensor check, for
    scripts that hold a tensor of their own; the pipeline does not call it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclasses.dataclass
class TraceResult:
    """What `trace` measured, filled when its window closes."""
    path: Optional[str] = None  # the Chrome trace's file
    wall_s: float = 0.0
    device_s: float = 0.0  # the summed duration of the device's events
    device_events: int = 0
    kernels: Dict[str, List[float]] = dataclasses.field(default_factory=dict)  # name → [n, s]

    @property
    def busy(self) -> float:
        """The card's busy share of the window (0 where nothing ran on it)."""
        return self.device_s / self.wall_s if self.wall_s > 0 else 0.0


@contextlib.contextmanager
def trace(logdir: Optional[str] = "traces", enabled: bool = True, name: str = "trace"):
    """Profile the `with` body: the CUDA card's kernels and copies where
    there is one, else the host's operators. Yields a `TraceResult`,
    complete once the body has run; the trace goes to
    `logdir`/`name`-<pid>-<ns>.json unless `logdir` is None. The device's
    events are summed straight from the raw trace: `key_averages()` builds
    an object a launch, which takes tens of seconds over a request's
    hundreds of thousands of launches."""
    result = TraceResult()
    if not enabled:
        yield result
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():  # "Profiler clears events at the end of each cycle"
        warnings.simplefilter("ignore", UserWarning)
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.__enter__()
    try:
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            yield result
        finally:
            if cuda:
                torch.cuda.synchronize()
            result.wall_s = time.perf_counter() - t
    finally:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            prof.__exit__(None, None, None)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = result.kernels.setdefault(e.name(), [0, 0.0])
            row[0] += 1
            row[1] += e.duration_ns() / 1e9
    result.device_events = sum(n for n, _ in result.kernels.values())
    result.device_s = sum(s for _, s in result.kernels.values())
    if logdir is not None:
        os.makedirs(logdir, exist_ok=True)
        result.path = os.path.join(logdir, f"{name}-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(result.path)


class Timer:
    """Hierarchical phase timer (reference modules/timer.py:5-91)."""

    def __init__(self, name: str = "total"):
        self.name = name
        self.start = time.time()
        self.records: Dict[str, float] = {}
        self.subcategory_level = 0
        self._category_stack: List[str] = []

    def elapsed(self) -> float:
        now = time.time()
        out = now - self.start
        self.start = now
        return out

    def record(self, category: str):
        prefix = "/".join(self._category_stack)
        key = f"{prefix}/{category}" if prefix else category
        self.records[key] = self.records.get(key, 0.0) + self.elapsed()

    @contextlib.contextmanager
    def subcategory(self, name: str):
        self.elapsed()
        self._category_stack.append(name)
        try:
            yield
        finally:
            self.record("total")
            self._category_stack.pop()

    def summary(self) -> str:
        total = sum(v for k, v in self.records.items() if "/" not in k)
        parts = ", ".join(f"{k}: {v:.1f}s" for k, v in sorted(self.records.items(),
                                                            key=lambda kv: -kv[1]))
        return f"{self.name}: {total:.1f}s ({parts})"


class MemoryMonitor:
    """The device's allocated bytes when a job starts and their peak while it
    runs (reference memmon.py): the allocator's own peak, reset at `start`,
    and `interval`-second samples of the card's used memory beside it. Zeros
    where there is no CUDA device."""

    def __init__(self, interval: float = 0.5, device=None):
        self.interval = interval
        self.device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.peak = 0
        self.baseline = 0
        self.used_peak = 0  # the card's used bytes (every process, any allocator), sampled

    def _cuda(self) -> bool:
        dev = torch.device(self.device) if self.device is not None else None
        return torch.cuda.is_available() and (dev is None or dev.type == "cuda")

    def _device_bytes(self) -> int:
        return int(torch.cuda.memory_allocated(self.device)) if self._cuda() else 0

    def _used_bytes(self) -> int:
        if not self._cuda():
            return 0
        free, total = torch.cuda.mem_get_info(self.device)
        return int(total - free)

    def start(self):
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)
        self.baseline = self._device_bytes()
        self.peak = self.baseline
        self.used_peak = self._used_bytes()
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            self.used_peak = max(self.used_peak, self._used_bytes())
            self._stop.wait(self.interval)

    def stop(self) -> Dict[str, int]:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1)
        if self._cuda():
            self.peak = max(self.peak, int(torch.cuda.max_memory_allocated(self.device)))
        return {"baseline": self.baseline, "peak": self.peak}


_NAN_MESSAGES = {
    "unet": ("A tensor with NaNs was produced in the UNet. This could be caused by a "
             "model trained in a different precision, a broken LoRA, or bad "
             "conditioning. Try float32 compute dtype."),
    "vae": ("A tensor with NaNs was produced in the VAE. Use a fixed fp16-safe VAE "
            "or float32 VAE dtype."),
}


class NansException(RuntimeError):
    pass


def test_for_nans(x, where: str = "unet", enabled: bool = True):
    """Raise the actionable message if `x` holds a NaN or an infinity
    (reference devices.py test_for_nans; off like --disable-nan-check). A
    tensor is reduced to one flag where it lies."""
    if not enabled:
        return
    if isinstance(x, torch.Tensor):
        bad = not bool(torch.isfinite(x.float()).all())
    else:
        bad = not bool(np.isfinite(np.asarray(x, dtype=np.float32)).all())
    if bad:
        raise_nans(where)


def raise_nans(where: str):
    """Raise the message of a stage ("unet", "vae", or any other name)."""
    raise NansException(_NAN_MESSAGES.get(where, f"A tensor with NaNs was produced at {where}."))
