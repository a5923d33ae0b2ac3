"""blackbox_tpu_torch — the PyTorch / CUDA port of blackbox_tpu.

The JAX package (:mod:`blackbox_tpu`) is the reference; this package
mirrors its layout (``core/``, ``ops/``, ``pipeline/``, ``synth/``) and
its public function names, so each module's counterpart is found under
the same path.  It imports ``torch`` and never ``jax``.

The ported paths are the per-frame reduction, raw 16-channel frame ->
calibrated mosaic + mask + catalog
(:func:`blackbox_tpu_torch.pipeline.reduce.make_reduce_fn`), the
science frame -> transient catalog
(:mod:`blackbox_tpu_torch.pipeline.subtract`) and the master frames
(:mod:`blackbox_tpu_torch.pipeline.masters`).  Every TPU kernel of the
JAX package is a hand-written CUDA kernel for Hopper (``csrc/``), built
with ``nvcc`` at first use and bound with ctypes
(:mod:`blackbox_tpu_torch.kernels`).  Each kernel's wrapper takes its
plain PyTorch version for CPU tensors and launches the kernel, or
raises, for CUDA tensors.

Float settings are fixed here, once: full float32 matmuls and
convolutions, the counterpart of the JAX package's
``Precision.HIGHEST`` pins (the background must be sub-ADU accurate).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
