"""One torch intra-op thread in each test process.

Every tests/test_torch_*.py imports this module first, so the setting takes
effect in each pytest-xdist worker while it collects, before any test runs.
The tier-1 run starts six workers on an eight-core host; at torch's default
of one intra-op thread a core, the six workers' OpenMP pools ask for 48
threads and spend most of their time waiting for each other (six copies of
tests/test_torch_hires_fields.py's slowest case at eight threads each did
not finish in 280 s, at one thread each they took 8 s). Results do not
depend on the thread count beyond the tests' tolerances.
"""

try:
    import torch
except ImportError:  # the files that need torch skip themselves
    torch = None

if torch is not None:
    torch.set_num_threads(1)
