"""PyTorch/CUDA port of ygz_slam_tpu for one NVIDIA H100.

The port keeps the JAX package's module and function names; each Pallas
kernel of the ported slice is a CUDA C++ kernel under `csrc/`, built with
nvcc at first use (`_build.py`) and bound through ctypes.  Every kernel
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version ("twin") for CPU tensors; any other device raises.

Entry points run on the card unless the caller passes `device="cpu"`
(see `resolve_device`).
"""
from __future__ import annotations

import torch

# Full float32 products everywhere.  TF32 keeps ~3 decimal digits; the
# JAX package recorded rounding of that kind making pose BA diverge, and
# the pyramid's banded-matrix product must stay f32-exact.  PyTorch's
# float32 matmul default is already off, but cuDNN's is on: set both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  With no device given and no GPU present it raises; it never
    picks the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ygz_slam_tpu_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
