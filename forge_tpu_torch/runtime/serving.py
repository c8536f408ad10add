"""Queue-driven serving (port of forge_tpu/runtime/serving.py): a staged
txt2img pipeline that overlaps the next request's host work with the
current request's denoise on the card.

  prep    (thread 1): seeds, LoRA activation, text encode, Philox noise
  denoise (thread 2): the sampler's step loop, then the VAE decode and the
          copy of its uint8 images and NaN flags to pinned host memory, all
          enqueued on the card's stream with no wait
  finish  (thread 3): wait for that copy's event, the NaN checks, the images

The stages are pipeline/processing.py's `setup` and `prepare`, `sample`
(the NGMS split where the options ask for it), `decode_dispatch` (whole,
tiled or TAESD, as the request's plan and options pick) /
`engine.decode_finish`, `finish` and `infotexts`, the code `process_images`
runs, so a served request gives the same bytes and infotexts as
`process_images` on the same `Processing`. All three threads launch onto
the default stream, and only the finish stage waits on the card, on its
own request's event. Each thread enters `torch.no_grad()` itself: grad mode
is thread-local. Only the denoise thread launches the counted kernels
(the text encoders' attention is masked and runs the plain version).

A failed stage fails its request's future with the exception and the
pipeline goes on with the next request. Requests with init images
(img2img), the hires fix, a refiner or `n_iter` > 1 are refused, as the
reference's serving takes plain txt2img requests, and so are the CFG hooks
(`pre_cfg_hooks`, `post_cfg_hooks`, `cfg_combine_hook`), `hook_phases` and
`deferred_hooks`, which no test holds against the reference's serving, and
`scripts`, whose request-level hooks (`setup`, `postprocess`, ...) the
stages do not run (the reference's serving drops them), and face
restoration (`restore_faces` or the `face_restoration` option), which the
reference's serving never runs. The CFG events fire
on the denoise thread, once a request, as the reference's serving fires
them. The prep stage makes the
request's memory plan as `process_images` does (`plan`), without chunking
the batch, as the reference's serving makes it: a tiled plan, TAESD or the
`vae_always_tiled` option pick the decode (`decode_dispatch`).
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import List

import torch

from ..pipeline import processing as proc
from ..runtime.options import opts

_STOP = object()  # the pill close() sends through the three queues


class ServingPipeline:
    """Pipelined txt2img serving; `depth` bounds each stage's queue."""

    def __init__(self, engine, depth: int = 4):
        self.engine = engine
        self._prep_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._denoise_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._finish_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._closed = False
        self._lock = threading.Lock()  # orders submit() against close()
        self._threads = [
            threading.Thread(target=self._run, args=(stage, inq, outq), daemon=True,
                             name=f"serve-{stage.__name__.strip('_')}")
            for stage, inq, outq in ((self._prep, self._prep_q, self._denoise_q),
                                     (self._denoise, self._denoise_q, self._finish_q),
                                     (self._finish, self._finish_q, None))]
        for t in self._threads:
            t.start()

    def submit(self, p: proc.Processing) -> Future:
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingPipeline is closed")
            fut: Future = Future()
            self._prep_q.put((p, fut, {}))
        return fut

    def close(self, wait: bool = True, timeout: float = 300.0) -> None:
        """Stop taking requests; those already submitted go through all three
        stages (or carry their exception), then the threads end. submit()
        afterwards raises."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._prep_q.put(_STOP)
        if wait:
            deadline = time.monotonic() + timeout
            for t in self._threads:
                t.join(max(deadline - time.monotonic(), 0.1))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def map(self, ps: List[proc.Processing]) -> List[dict]:
        futs = [self.submit(p) for p in ps]
        return [f.result() for f in futs]

    # -- stages: each takes (p, future, timings, state) and returns the next state --

    def _run(self, stage, inq: "queue.Queue", outq) -> None:
        with torch.no_grad():
            while True:
                item = inq.get()
                if item is _STOP:
                    if outq is not None:
                        outq.put(_STOP)
                    return
                p, fut, timings, *state = item
                t0 = time.perf_counter()
                try:
                    out = stage(p, timings, *state)
                except Exception as e:  # noqa: BLE001 — fail this request, serve the next
                    fut.set_exception(e)
                    continue
                timings[stage.__name__.strip("_")] = time.perf_counter() - t0
                if outq is None:
                    fut.set_result(out)
                else:
                    outq.put((p, fut, timings) + out)

    def _prep(self, p, timings):
        if (p.init_images is not None or p.n_iter != 1 or p.enable_hr
                or proc._refiner_step(p, max(p.steps, 2)) is not None):
            raise NotImplementedError("serving takes plain txt2img requests of one batch "
                                      "(no init_images, hires fix or refiner; n_iter 1); "
                                      "use process_images")
        if p.scripts is not None:
            raise NotImplementedError("serving with scripts is not ported: its threads do not "
                                      "run the request-level hooks (ROADMAP.md queue 1 item 7); "
                                      "use process_images")
        if p.restore_faces or opts.get("face_restoration"):
            raise NotImplementedError("serving with restore_faces (or the face_restoration "
                                      "option) is not ported: the reference's serving never "
                                      "restores (ROADMAP.md queue 1 item 7, serving); use "
                                      "process_images")
        asked = [name for name in proc.CFG_HOOK_FIELDS + proc.IMAGE_PROMPT_FIELDS
                 + ("hook_phases", "deferred_hooks") if getattr(p, name)]
        if asked:
            raise NotImplementedError(f"serving with {', '.join(asked)} is not ported: no test "
                                      "holds it against the reference's serving; use "
                                      "process_images")
        proc.setup(self.engine, p)
        proc.plan(self.engine, p, chunk=False)
        return (proc.prepare(self.engine, p, 0, timings),)

    def _denoise(self, p, timings, job):
        latent, _ = proc.sample(self.engine, job, timings)
        t0 = time.perf_counter()
        handle, _ = proc.decode_dispatch(self.engine, latent, p)
        timings["decode_dispatch"] = time.perf_counter() - t0
        return job, handle

    def _finish(self, p, timings, job, handle):
        images = proc.finish(job, self.engine.decode_finish(handle))
        return {"images": images, "seeds": list(p.all_seeds),
                "infotexts": proc.infotexts(p, job.seeds, job.subseeds), "timings": timings}


def serve_throughput(engine, ps: List[proc.Processing], depth: int = 4) -> dict:
    """Run a list of requests through the pipeline → {wall_s, n_images,
    images_per_s, outputs} (each output {images, seeds, infotexts, timings})."""
    pipe = ServingPipeline(engine, depth=depth)
    try:
        t0 = time.perf_counter()
        outs = pipe.map(ps)
        wall = time.perf_counter() - t0
    finally:
        pipe.close()
    n_images = sum(len(o["images"]) for o in outs)
    return {"wall_s": wall, "n_images": n_images, "images_per_s": n_images / wall,
            "outputs": outs}
