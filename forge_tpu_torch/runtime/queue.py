# Copied from forge_tpu/runtime/queue.py (Task, WorkQueue and the module's `work_queue`).
"""Single-worker generation queue.

Every generation (and every checkpoint load) runs on one worker thread, so
the card's work is issued from that thread alone and requests never
interleave; callers block on the task (the reference's `run_and_wait`).
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Any, Callable, Optional


class Task:
    def __init__(self, fn: Callable, args, kwargs):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.done = threading.Event()
        self.result: Any = None
        self.exception: Optional[BaseException] = None

    def run(self):
        try:
            self.result = self.fn(*self.args, **self.kwargs)
        except BaseException as e:  # noqa: BLE001 — surfaced to the caller
            self.exception = e
            self.traceback = traceback.format_exc()
        finally:
            self.done.set()

    def wait(self, timeout: Optional[float] = None):
        if not self.done.wait(timeout):
            raise TimeoutError("task did not finish in time")
        if self.exception is not None:
            raise self.exception
        return self.result


class WorkQueue:
    def __init__(self):
        self._q: "queue.Queue[Task]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="forge-torch-worker")
            self._thread.start()

    def stop(self):
        self._stop.set()
        self._q.put(Task(lambda: None, (), {}))  # wake the loop

    def _loop(self):
        while not self._stop.is_set():
            task = self._q.get()
            if self._stop.is_set():
                break
            task.run()

    def submit(self, fn: Callable, *args, **kwargs) -> Task:
        self.start()
        task = Task(fn, args, kwargs)
        self._q.put(task)
        return task

    def run_and_wait(self, fn: Callable, *args, **kwargs):
        return self.submit(fn, *args, **kwargs).wait()


work_queue = WorkQueue()
