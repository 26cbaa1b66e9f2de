"""One torch thread for the port's tests. Each tests/test_torch_*.py (and
test_cuda_emu.py) imports this module before anything else. The port's
CPU paths are many small torch ops, and the suite runs its files side by
side on several workers, so torch's own pool only adds contention. The
Python processes those tests start inherit OMP_NUM_THREADS, which torch
reads when it is first imported."""

import os

os.environ["OMP_NUM_THREADS"] = "1"

import torch  # noqa: E402

torch.set_num_threads(1)
