"""One torch intra-op thread in each test process, and no file written into
the repository by the port.

Every tests/test_torch_*.py imports this module first, so the settings take
effect in each pytest-xdist worker while it collects, before any test runs.
The tier-1 run starts six workers on an eight-core host; at torch's default
of one intra-op thread a core, the six workers' OpenMP pools ask for 48
threads and spend most of their time waiting for each other (six copies of
tests/test_torch_hires_fields.py's slowest case at eight threads each did
not finish in 280 s, at one thread each they took 8 s). Results do not
depend on the thread count beyond the tests' tolerances.

The port's `process_images` saves every image, its grid and `params.txt`
under the reference's default options, and its event log appends to
`logs/events.jsonl`. tests/conftest.py turns forge_tpu's `samples_save` and
`save_write_params_txt` off; this module turns off the port's two, and its
`grid_save` as well, and points the port's event log at a file in a
temporary directory. forge_tpu's `grid_save` goes off too: the port's tests
run forge_tpu's `process_images` at batch 2 and more, whose grids would
land in `outputs/txt2img-grids/` (no forge_tpu test reads that option). A
test of saving turns an option on with its outputs under `tmp_path` and
puts the value back; a test of the event log points the sink at `tmp_path`
and puts this one back.
"""

import os
import tempfile

try:
    import torch
except ImportError:  # the files that need torch skip themselves
    torch = None

EVENT_LOG = os.path.join(tempfile.mkdtemp(prefix="forge_torch_events_"), "events.jsonl")

if torch is not None:
    torch.set_num_threads(1)
    from forge_tpu_torch.runtime import logging as _event_log
    from forge_tpu_torch.runtime.options import opts as _opts

    for _key in ("samples_save", "save_write_params_txt", "grid_save"):
        _opts.set(_key, False)
    _event_log.configure(EVENT_LOG)
    try:
        from forge_tpu.runtime.options import opts as _reference_opts
    except ImportError:  # no JAX: the files that need it skip themselves
        pass
    else:
        _reference_opts.set("grid_save", False, run_onchange=False)
