"""The plain reference of the benchmark: a frozen copy of the port's
reduction and subtraction paths (``core/``, ``config/``, ``ops/``,
``pipeline/``, ``astro/photcal.py``), with every hand-written kernel's
route replaced by the plain PyTorch version the port keeps beside it,
and the imports rewritten to this package.

It imports nothing of the program under test and no JAX: the harness
runs it on the inputs it made itself, after the measured window, and
compares what the program produced against it (``portbench/compare.py``).
It runs on any device, the card included, always through the plain
versions.

Float settings are fixed here, as the port fixes them: full float32
matmuls and convolutions (no TF32).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
