# Copied from forge_tpu/runtime/state.py (State and the module's `state`); the preview PNG is the port's own writer.
"""Job state: progress, interrupt and skip, and the live preview.

One global `state` that the API begins and ends around each generation,
the sampler loop ticks (pipeline/processing.py) and `/sdapi/v1/progress`
reads. The loop stops at the next step boundary once `interrupted` (the
whole request) or `skipped` (the current batch) is set while a job runs.
"""

from __future__ import annotations

import base64
import threading
import time
from typing import Any, Dict, Optional

import numpy as np


class State:
    def __init__(self):
        self._lock = threading.RLock()
        self.reset()

    def reset(self):
        with self._lock:
            self.job = ""
            self.job_no = 0
            self.job_count = 0
            self.sampling_step = 0
            self.sampling_steps = 0
            self.interrupted = False
            self.skipped = False
            self.job_timestamp = ""
            self.time_start = 0.0
            self.current_image: Optional[np.ndarray] = None
            self.current_image_sampling_step = 0
            self.textinfo = ""

    def begin(self, job: str, job_count: int = 1, steps: int = 0):
        with self._lock:
            self.reset()
            self.job = job
            self.job_count = job_count
            self.sampling_steps = steps
            self.time_start = time.time()
            self.job_timestamp = time.strftime("%Y%m%d%H%M%S")

    def end(self):
        with self._lock:
            self.job = ""

    def step(self, n: int = 1):
        with self._lock:
            self.sampling_step += n
        if self.interrupted:
            raise InterruptedError("generation interrupted")

    def interrupt(self):
        self.interrupted = True

    def skip(self):
        self.skipped = True

    def set_current_image(self, img: np.ndarray):
        with self._lock:
            self.current_image = img
            self.current_image_sampling_step = self.sampling_step

    def progress(self) -> float:
        with self._lock:
            total = max(self.sampling_steps * max(self.job_count, 1), 1)
            done = self.sampling_step + self.job_no * self.sampling_steps
            return min(done / total, 1.0)

    def eta(self) -> Optional[float]:
        with self._lock:
            p = self.progress()
            if p <= 0 or not self.time_start:
                return None
            elapsed = time.time() - self.time_start
            return elapsed / p - elapsed

    def current_image_base64(self) -> Optional[str]:
        with self._lock:
            img = self.current_image
        if img is None:
            return None
        from ..pipeline.images import encode_png

        return base64.b64encode(encode_png(np.asarray(img, np.uint8))).decode()

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "skipped": self.skipped,
                "interrupted": self.interrupted,
                "job": self.job,
                "job_count": self.job_count,
                "job_no": self.job_no,
                "sampling_step": self.sampling_step,
                "sampling_steps": self.sampling_steps,
                "job_timestamp": self.job_timestamp,
            }


state = State()
