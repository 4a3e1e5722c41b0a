"""Whitened-residual chi^2, chi2[w] = || Linv @ delta[w] ||^2.

The card's implementation is the hand-written CUDA kernel in
``cosmax_torch/csrc/whitened_chi2.cu`` (it replaces the TPU kernel
``cosmax/ops/pallas/chi2.py::whitened_chi2_pallas``; the source note
there says what bounds it on an H100 and how the design answers that).

Dispatch is by the device of the inputs and nothing else: CPU tensors
take the plain PyTorch version below, CUDA tensors launch the kernel or
raise. There is no fallback from the kernel to the plain version.

Gradients: on CUDA the kernel is the forward of ``_WhitenedChi2``, a
``torch.autograd.Function`` whose backward is the plain product
d chi2 / d delta = 2 (delta Linv^T) Linv, two IEEE-f32 matmuls (the JAX
package leaves the same product to XLA, outside its Pallas kernel, when
``jax.grad`` passes the SN term). The backward is built from
differentiable ops, so a Hessian goes through it too. Linv is a constant
of the likelihood and gets no gradient. On the CPU the plain version is
differentiable as it is.
"""

import ctypes

import torch

# Kernel launches made by ``whitened_chi2`` since the last reset; a run
# reads it to show that its main path went through the kernel.
LAUNCHES = 0


def whitened_chi2_reference(linv: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: delta [W, N], linv [N, N] -> [W]."""
    return ((delta @ linv.T) ** 2).sum(-1)


def _check(linv: torch.Tensor, delta: torch.Tensor) -> None:
    if delta.dim() != 2 or linv.dim() != 2:
        raise ValueError(
            f"whitened_chi2 takes delta [W, N] and linv [N, N]; got "
            f"{tuple(delta.shape)} and {tuple(linv.shape)}"
        )
    n = delta.shape[1]
    if linv.shape != (n, n):
        raise ValueError(
            f"linv must be [{n}, {n}] to match delta [W, {n}]; got {tuple(linv.shape)}"
        )
    if linv.device != delta.device:
        raise ValueError(f"linv on {linv.device} but delta on {delta.device}")


def whitened_chi2(linv: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """chi^2 over a walker batch; ``linv`` must be lower-triangular (the
    inverted Cholesky factor from ``ops.linalg.whitening_operator``):
    the CUDA kernel skips its upper triangle.

    CPU tensors: the plain version, any float dtype. CUDA tensors: the
    kernel, which takes contiguous float32 only and raises otherwise;
    differentiable in ``delta`` (twice) through ``_WhitenedChi2``.
    """
    _check(linv, delta)
    if delta.device.type == "cpu":
        return whitened_chi2_reference(linv, delta)
    if delta.device.type != "cuda":
        raise ValueError(f"whitened_chi2 has no kernel for device {delta.device}")
    if linv.requires_grad:
        raise ValueError("whitened_chi2 gives no gradient in linv, a constant of the likelihood")
    return _WhitenedChi2.apply(linv, delta)


def whitened_chi2_grad(linv: torch.Tensor, delta: torch.Tensor, g: torch.Tensor):
    """The backward of chi2 = ||Linv delta||^2: g[:, None] * 2 (delta Linv^T)
    Linv, from differentiable ops (the Hessian's double backward goes
    through it)."""
    return (2.0 * g)[:, None] * ((delta @ linv.T) @ linv)


class _WhitenedChi2(torch.autograd.Function):
    """The kernel as the forward; ``whitened_chi2_grad`` as the backward."""

    @staticmethod
    def forward(ctx, linv, delta):
        ctx.save_for_backward(linv, delta)
        return _launch(linv, delta)

    @staticmethod
    def backward(ctx, g):
        linv, delta = ctx.saved_tensors
        return None, whitened_chi2_grad(linv, delta, g)


def _launch(linv: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    for name, t in (("linv", linv), ("delta", delta)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    w, n = delta.shape
    out = torch.empty(w, dtype=torch.float32, device=delta.device)
    if w == 0 or n == 0:
        return out.zero_()
    from cosmax_torch.ops.kernels.build import load_kernel

    fn = _entry(load_kernel("whitened_chi2").lib)
    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(linv.data_ptr(), delta.data_ptr(), out.data_ptr(), w, n, stream)
    if err != 0:
        raise RuntimeError(f"whitened_chi2 kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _entry(lib: ctypes.CDLL):
    fn = lib.cosmax_whitened_chi2_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn
