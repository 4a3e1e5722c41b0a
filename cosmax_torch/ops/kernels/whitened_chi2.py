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

Row blocks: ``whitened_chi2_rows(linv_rows, delta)`` is the share of the
rows [row0, row0 + rows) of Linv, from the slab ``Linv[row0 : row0 + rows,
: row0 + rows]`` alone (row0 = its width less its rows: a lower-triangular
row has no value past its diagonal); the blocks' shares add up to chi^2.
On CUDA a slab of fewer rows than N goes to its own kernel,
``cosmax_torch/csrc/whitened_chi2_rows.cu`` (wgmma in 3xTF32, the slab by
TMA), with the same autograd Function (backward 2 g (delta L_b^T) L_b).
That kernel reads the slab split into TF32 halves (hi + lo is the slab
bit for bit) through a TMA tensor map. A caller that keeps a slab passes
it as a ``RowBlock``, which holds the slab and, from the kernel's first
launch on, its split and tensor map (``parallel.mesh.data_sharded_chi2``
does); a bare tensor is split again at every call. ``row_blocks`` splits
the rows by equal work: a block's cost is its rows' lengths, ~r1^2 - r0^2
on the triangle, so equal rows would give the last of two blocks 3/4 of it.
"""

import ctypes
from dataclasses import dataclass

import torch

# Kernel launches made by ``whitened_chi2`` and ``whitened_chi2_rows`` (the
# square kernel or the row-block kernel) since the last reset; a run reads
# it to show that its main path went through the kernels. ROWS_LAUNCHES
# counts the row-block kernel's launches alone (each also counts in LAUNCHES).
LAUNCHES = 0
ROWS_LAUNCHES = 0

# The row-block kernel's layout (whitened_chi2_rows.cu, which holds the same
# constants): its row tile, the wgmma's n; the k of a stage; the split
# slab's row stride, a multiple of SPLIT_PAD floats (the TMA's 16-byte
# strides). The kernel takes a slab of any rows; ``row_blocks`` cuts on
# multiples of ROW_STEP rows.
ROW_TILE = 128
STAGE_K = 32
SPLIT_PAD = 4
ROW_STEP = 8


def whitened_chi2_reference(linv: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: delta [W, N], linv [N, N] -> [W]."""
    return ((delta @ linv.T) ** 2).sum(-1)


def whitened_chi2_rows_reference(linv_rows: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of a row block: linv_rows [rows, ld] (the slab
    of rows [ld - rows, ld), columns [0, ld)), delta [W, N >= ld] -> [W]."""
    ld = linv_rows.shape[1]
    return ((delta[:, :ld] @ linv_rows.T) ** 2).sum(-1)


def row_blocks(n: int, parts: int) -> list:
    """Boundaries [b_0 = 0, ..., b_parts = n] of ``parts`` row blocks of an
    n x n lower triangle by equal work: b_k = n sqrt(k / parts), rounded to
    a multiple of ROW_STEP (a block's work is then within a few rows of its
    share) and kept in [0, n]. A block may be empty when n is small against
    the step."""
    if parts < 1:
        raise ValueError(f"parts must be >= 1; got {parts}")
    cuts = [min(n, ROW_STEP * round(n * (k / parts) ** 0.5 / ROW_STEP))
            for k in range(1, parts)]
    return [0] + cuts + [n]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero: the bits of ``cvt.rna.tf32.f32`` for a finite x
    (``csrc/tf32.cuh``'s tf32_rna), as float32 with the low 13 bits zero."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32; got {x.dtype}")
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


@dataclass(eq=False)
class RowBlock:
    """A row block's slab [rows, ld] as the row-block kernel reads it:
    ``slab`` itself, ``hilo`` [2, rows, ldp] its split into TF32 halves
    (``split_rows``; made at the kernel's first launch if not before) and
    the kernel's tensor map of ``hilo`` (built at the first launch). Kept
    together, so that a split never meets another slab."""

    slab: torch.Tensor
    hilo: torch.Tensor = None
    tensor_map: object = None  # ctypes buffer of the CUtensorMap

    @property
    def rows(self) -> int:
        return self.slab.shape[0]

    @property
    def ld(self) -> int:
        return self.slab.shape[1]

    def unsplit(self) -> torch.Tensor:
        """hi + lo [rows, ld]: the slab, bit for bit."""
        return (self.hilo[0] + self.hilo[1])[:, : self.ld]


def split_rows(linv_rows: torch.Tensor) -> RowBlock:
    """The slab [rows, ld] (float32) split for the row-block kernel: hi =
    tf32(x) and lo = x - hi exactly (so hi + lo == x; the tensor cores read
    lo's top 19 bits), the row stride ld rounded up to SPLIT_PAD floats,
    the padding zero."""
    if linv_rows.dtype != torch.float32 or linv_rows.dim() != 2:
        raise TypeError(f"split_rows takes a float32 slab [rows, ld]; got "
                        f"{linv_rows.dtype} {tuple(linv_rows.shape)}")
    rows, ld = linv_rows.shape
    hi = tf32_round(linv_rows)
    hilo = linv_rows.new_zeros((2, rows, -(-ld // SPLIT_PAD) * SPLIT_PAD))
    hilo[0, :, :ld] = hi
    hilo[1, :, :ld] = linv_rows - hi
    return RowBlock(linv_rows, hilo)


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


def _check_rows(linv_rows: torch.Tensor, delta: torch.Tensor) -> None:
    if delta.dim() != 2 or linv_rows.dim() != 2:
        raise ValueError(
            f"whitened_chi2_rows takes delta [W, N] and linv_rows [rows, ld]; got "
            f"{tuple(delta.shape)} and {tuple(linv_rows.shape)}"
        )
    rows, ld = linv_rows.shape
    if not rows <= ld <= delta.shape[1]:
        raise ValueError(
            f"linv_rows [{rows}, {ld}] is no row block of an N = {delta.shape[1]} "
            "triangle (rows <= ld <= N)"
        )
    if linv_rows.device != delta.device:
        raise ValueError(f"linv_rows on {linv_rows.device} but delta on {delta.device}")


def whitened_chi2_rows(linv_rows, delta: torch.Tensor) -> torch.Tensor:
    """The rows [ld - rows, ld) of Linv's share of chi^2 over a walker
    batch, from the slab ``linv_rows`` [rows, ld] (lower-triangular rows),
    a tensor or a ``RowBlock`` of it.

    CPU tensors: the plain version. CUDA tensors: the row-block kernel
    (the square kernel for a slab of all N rows), contiguous float32 only,
    else it raises; differentiable in ``delta`` through ``_WhitenedChi2``.
    A ``RowBlock`` keeps the slab's split and tensor map from one call to
    the next; a bare tensor is split at every call."""
    block = linv_rows if isinstance(linv_rows, RowBlock) else None
    if block is not None:
        linv_rows = block.slab
    _check_rows(linv_rows, delta)
    if delta.device.type == "cpu":
        return whitened_chi2_rows_reference(linv_rows, delta)
    if delta.device.type != "cuda":
        raise ValueError(f"whitened_chi2_rows has no kernel for device {delta.device}")
    if linv_rows.requires_grad:
        raise ValueError("whitened_chi2_rows gives no gradient in linv, a constant of the likelihood")
    return _WhitenedChi2.apply(linv_rows, delta, block)


def whitened_chi2_grad(linv: torch.Tensor, delta: torch.Tensor, g: torch.Tensor):
    """The backward of chi2 = ||Linv delta||^2: g[:, None] * 2 (delta Linv^T)
    Linv, from differentiable ops (the Hessian's double backward goes
    through it). ``linv`` may be a row block's slab [rows, ld]: the
    gradient is then 2 g (delta L_b^T) L_b, zero past column ld."""
    ld = linv.shape[1]
    if ld == delta.shape[1]:
        return (2.0 * g)[:, None] * ((delta @ linv.T) @ linv)
    part = (2.0 * g)[:, None] * ((delta[:, :ld] @ linv.T) @ linv)
    return torch.nn.functional.pad(part, (0, delta.shape[1] - ld))


class _WhitenedChi2(torch.autograd.Function):
    """The kernel (the square kernel, or the row-block kernel for a slab,
    through its ``RowBlock`` if the caller keeps one) as the forward;
    ``whitened_chi2_grad`` as the backward."""

    @staticmethod
    def forward(ctx, linv, delta, block=None):
        ctx.save_for_backward(linv, delta)
        return _launch(linv, delta) if block is None else _launch(linv, delta, block)

    @staticmethod
    def backward(ctx, g):
        linv, delta = ctx.saved_tensors
        return None, whitened_chi2_grad(linv, delta, g), None


def _launch(linv: torch.Tensor, delta: torch.Tensor, block=None) -> torch.Tensor:
    for name, t in (("linv", linv), ("delta", delta)):
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernel takes float32 {name}; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"the CUDA kernel takes a contiguous {name}")
    w, n = delta.shape
    rows, ld = linv.shape
    out = torch.empty(w, dtype=torch.float32, device=delta.device)
    if w == 0 or rows == 0:
        return out.zero_()
    from cosmax_torch.ops.kernels.build import load_kernel

    with torch.cuda.device(delta.device):
        stream = torch.cuda.current_stream().cuda_stream
        if rows == n:  # the square kernel
            lib = load_kernel("whitened_chi2").lib
            err = _entry(lib)(linv.data_ptr(), delta.data_ptr(), out.data_ptr(), w, n, stream)
        else:
            if block is None:
                block = RowBlock(linv)
            if block.hilo is None:
                block.hilo = split_rows(linv).hilo
            lib = load_kernel("whitened_chi2_rows").lib
            err = _rows_entry(lib)(_tensor_map(block), delta.data_ptr(), out.data_ptr(), w, n,
                                   ld - rows, rows, stream)
    if err != 0:
        raise RuntimeError(f"whitened_chi2 kernel launch failed: cudaError {err}")
    global LAUNCHES, ROWS_LAUNCHES
    LAUNCHES += 1
    if rows != n:
        ROWS_LAUNCHES += 1
    return out


def _tensor_map(block: RowBlock):
    """The row-block kernel's TMA tensor map of ``block.hilo``, built by the
    kernel library at the first call and kept on the block, which also
    keeps the memory it addresses."""
    if block.tensor_map is None:
        from cosmax_torch.ops.kernels.build import load_kernel

        block.tensor_map = encode_tensor_map(load_kernel("whitened_chi2_rows").lib, block)
    return block.tensor_map


def encode_tensor_map(lib: ctypes.CDLL, block: RowBlock):
    """The TMA tensor map of ``block.hilo`` by ``lib``'s host entry (a
    128-byte ctypes buffer): a box of [2][ROW_TILE][STAGE_K] f32, the rows
    past ``block.rows`` and the columns past ``block.ld`` read as zeros."""
    fn = lib.cosmax_chi2_rows_tensor_map
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_longlong]
        fn.restype = ctypes.c_int
    buf = ctypes.create_string_buffer(128)
    err = fn(buf, block.hilo.data_ptr(), block.rows, block.ld, block.hilo.shape[2])
    if err != 0:
        raise RuntimeError(f"the row-block kernel's tensor map failed: CUresult {err}"
                           + (" (the driver has no cuTensorMapEncodeTiled)" if err == -1 else ""))
    return buf


def _entry(lib: ctypes.CDLL):
    fn = lib.cosmax_whitened_chi2_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def _rows_entry(lib: ctypes.CDLL):
    fn = lib.cosmax_whitened_chi2_rows_f32
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn
