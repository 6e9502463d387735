"""Intra-op threads of the port's tests, imported by every
``tests/test_torch_*.py``.

torch starts one intra-op thread a core. Under pytest-xdist every worker
does, so N workers run N threads a core, and OpenMP's spinning threads wait
on each other: the port's heavy files ran ~10x slower than in one process.
Here each worker takes its share of the cores (all of them without xdist).
Importing this module in one test file sets it for the whole worker
process, since each worker imports every test file it collects.
"""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
