"""Device and precision policy of the port (counterpart of
``cosmax/utils/dtypes.py``).

* On the card the runtime is float32. Every f32 matmul must be full
  IEEE f32: TF32 keeps about three decimal digits, which is the same
  trap as the TPU's bf16 default that ``cosmax.ops.linalg.pdot`` guards
  against (chi^2 errors of order unity at N ~ 2000). ``resolve`` pins
  both TF32 switches off.
* On the CPU float64 is allowed as well: the parity tests hold the port
  against the JAX package in f64.
"""

import torch


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve(device="cuda", dtype=None):
    """(torch.device, torch.dtype) for an explicit device; dtype defaults
    to float32. Raises when CUDA is asked for and absent, and for float64
    on the card (the kernels take float32)."""
    device = torch.device(device)
    dtype = torch.float32 if dtype is None else dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"runtime dtype must be float32 or float64; got {dtype}")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if dtype != torch.float32:
            raise TypeError("the runtime on the card is float32")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    disable_tf32()
    return device, dtype
