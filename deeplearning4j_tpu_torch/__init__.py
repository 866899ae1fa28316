"""PyTorch / CUDA port of `deeplearning4j_tpu`, for one NVIDIA H100.

The package mirrors the JAX package's layout and module names so each
ported module sits where its reference does (`attention/flash.py` is the
counterpart of `attention/flash_pallas.py`, `serving/paged_kv.py` of
`serving/paged_kv.py`, ...). It imports `torch` and never `jax`, and
nothing of the JAX package: where it needs code from there it keeps its
own copy.

Device policy: every entry point takes `device=None`, and `None` means
the current CUDA device. With no CUDA device present, `None` raises —
nothing falls back to the CPU quietly. The CPU is used only when the
caller passes `device="cpu"` (the tests do), and there every kernel
wrapper runs its plain PyTorch version.

Float32 precision policy: importing this package sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, so a float32 matrix product
or convolution on the card keeps full float32 precision, as the JAX
reference does on the CPU.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["default_device"]


def default_device(device=None) -> torch.device:
    """Resolve an entry point's `device=` argument: None -> the current
    CUDA device (raises without one); anything else is taken as given,
    and an explicit CUDA device without a card raises too."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device "
                           f"is available")
    return device
