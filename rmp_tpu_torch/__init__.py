"""rmp_tpu_torch — Riemannian Motion Policies in PyTorch, with CUDA kernels
for NVIDIA Hopper.

The PyTorch counterpart of the `rmp_tpu` JAX package, which stays the
reference it is tested against. The module layout mirrors the JAX package
(models/, ops/, sim/, policies/, envs/, core.py, taskmaps.py), so each
counterpart is found by path. Inside, every function works on batch-first
tensors: the JAX code's per-env functions under `vmap` become functions of a
leading batch axis B written out.

This package imports torch and numpy only, never jax and nothing of
`rmp_tpu`.
"""

__version__ = "0.1.0"

import torch as _torch

# The workload is small-matrix fp32 numerics (4x4 chain products, small
# pullbacks, up to 18x18 solves); reduced-precision matmul passes broke
# trajectory parity in the JAX package, which pins full fp32 for the same
# reason. TF32 keeps about three decimal digits, so it is off for matmuls and
# cuDNN.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> _torch.device:
    """The device an entry point runs on: `device` when given, else the
    card. Raises when no card is present and no device was asked for, so a
    CPU run is always an explicit choice of the caller."""
    if device is not None:
        return _torch.device(device)
    if not _torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: rmp_tpu_torch entry points run on the GPU "
            "unless the caller passes device='cpu'")
    return _torch.device("cuda")
