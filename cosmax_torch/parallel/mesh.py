"""Walker and data sharding over a ``torch.distributed`` device mesh
(counterpart of ``cosmax/parallel/mesh.py``).

The two scaling axes of the workload map onto a mesh of ranks, one
process per rank (SPMD):

* ``'w'`` (walkers, data-parallel; with ``'s'`` in front on a
  multi-slice mesh): each rank holds a contiguous block of the walker
  axis. The only traffic a sampler step makes is the gather of the
  complementary half of the red-black update, a [W/2, D] block
  (kilobytes).
* ``'d'`` (data): the rows of a large SN whitener (up to 1829^2) are
  split over the ranks of ``'d'``. Each keeps only its slab of L^-1, forms
  its rows' share of chi^2 with the chi^2 kernel's row-block entry, and the
  shares are summed over ``'d'``.

Collectives are ``all_reduce`` only, on the rank's own device: NCCL on
the card, gloo on the CPU (and gloo on a card, which reduces CUDA tensors
but gathers none). A gather is an ``all_reduce`` of a zeroed buffer into
which each rank writes its block: it adds zeros, so it is exact.

A rank computes on ``mesh_device(mesh)``: ``cuda:<current device>`` for a
mesh of device type ``"cuda"``, else the CPU. A mesh takes its device type
from the rank's device (``set_rank_device``, which the spawn helper and
the dry run's CLI call) and raises when asked for another; with no rank
device recorded it is the card under NCCL or wherever CUDA is. Nothing
falls back to the CPU or to a single rank.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from cosmax_torch.ops.kernels.whitened_chi2 import (
    RowBlock,
    row_blocks,
    whitened_chi2_grad,
    whitened_chi2_rows,
)

DATA = "d"


_rank_device = None


def set_rank_device(device) -> None:
    """Record this rank's device: a mesh built on the rank takes its type."""
    global _rank_device
    _rank_device = torch.device(device)


def mesh_device_type(requested=None, rank_device=None, backend=None) -> str:
    """A mesh's device type: ``requested``, which must agree with the
    rank's device where one is recorded; else the rank device's type; else
    ``"cuda"`` under NCCL or wherever CUDA is, and ``"cpu"`` only without
    it."""
    rank_type = None if rank_device is None else torch.device(rank_device).type
    if requested is None:
        if rank_type is not None:
            return rank_type
        return "cuda" if backend == "nccl" or torch.cuda.is_available() else "cpu"
    if rank_type is not None and requested != rank_type:
        raise ValueError(f"a {requested!r} mesh on a rank whose device is {rank_device}")
    return requested


def _device_type(device_type):
    return mesh_device_type(device_type, _rank_device, dist.get_backend())


def make_mesh(walkers: int = None, data: int = 1, device_type: str = None):
    """``DeviceMesh`` with dims ('w', 'd') over the whole world; by default
    every rank on 'w'. ``device_type`` defaults to the rank's device's
    (``mesh_device_type``)."""
    world = dist.get_world_size()
    if walkers is None:
        walkers = world // data
    if walkers * data != world:
        raise ValueError(f"mesh {walkers}x{data} != {world} ranks available")
    return init_device_mesh(_device_type(device_type), (walkers, data),
                            mesh_dim_names=("w", DATA))


def make_multislice_mesh(n_slices: int, walkers: int = None, data: int = 1,
                         device_type: str = None):
    """('s', 'w', 'd') mesh: the walker axis is split over ('s', 'w'); the
    chi^2 sum over covariance rows stays on the innermost 'd'."""
    world = dist.get_world_size()
    if walkers is None:
        walkers = world // (n_slices * data)
    if n_slices * walkers * data != world:
        raise ValueError(f"mesh {n_slices}x{walkers}x{data} != {world} ranks")
    return init_device_mesh(_device_type(device_type), (n_slices, walkers, data),
                            mesh_dim_names=("s", "w", DATA))


def walker_axes(mesh) -> tuple:
    """The dims the walker axis is split over: every dim except 'd'."""
    return tuple(n for n in mesh.mesh_dim_names if n != DATA)


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if mesh.device_type != "cpu":
        raise ValueError(f"unsupported mesh device type {mesh.device_type!r}")
    return torch.device("cpu")


def _coord(mesh, name) -> int:
    return int(mesh.get_coordinate()[mesh.mesh_dim_names.index(name)])


def walker_rank(mesh):
    """(this rank's index, count) over the walker axes, row-major."""
    index, count = 0, 1
    for name in walker_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index, count = index * size + _coord(mesh, name), count * size
    return index, count


def data_rank(mesh):
    """(this rank's index, count) on 'd'."""
    return _coord(mesh, DATA), mesh.size(mesh.mesh_dim_names.index(DATA))


def _bounds(n: int, index: int, count: int, parts: int = 1):
    """Rows of this rank's block of each of ``parts`` equal parts of n."""
    if n % (parts * count):
        raise ValueError(f"{n} rows do not split into {parts} part(s) x {count} ranks")
    size = n // (parts * count)
    return [(p * (n // parts) + index * size, p * (n // parts) + (index + 1) * size)
            for p in range(parts)]


def local_rows(mesh, n: int, parts: int = 1) -> list:
    """[(lo, hi)] of this rank's rows in each of ``parts`` equal parts of a
    walker axis of n rows (``parts=2``: the red-black halves)."""
    return _bounds(n, *walker_rank(mesh), parts)


def shard_walkers(mesh, walkers: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """This rank's block of a global [W, ...] tensor that every rank holds:
    its contiguous block over the walker axes of each of ``parts`` equal
    parts, concatenated (replicated over 'd'), on the rank's device."""
    blocks = [walkers[lo:hi] for lo, hi in local_rows(mesh, walkers.shape[0], parts)]
    out = blocks[0] if parts == 1 else torch.cat(blocks)
    return out.to(mesh_device(mesh))


def _gather(local: torch.Tensor, n_ranks: int, index: int, group, write: bool,
            parts: int = 1) -> torch.Tensor:
    """[n_ranks x the local rows] from every rank's block by an all_reduce
    of a zeroed buffer (exact: the blocks meet only zeros). Only the ranks
    with ``write`` contribute; a bool tensor travels as uint8. One rank's
    block is returned as it is."""
    if n_ranks == 1:  # the block is the whole
        return local
    is_bool = local.dtype == torch.bool
    x = local.to(torch.uint8) if is_bool else local
    m = x.shape[0] // parts
    buf = x.new_zeros((n_ranks * x.shape[0],) + tuple(x.shape[1:]))
    if write:
        for p in range(parts):
            lo = p * n_ranks * m + index * m
            buf[lo:lo + m] = x[p * m:(p + 1) * m]
    dist.all_reduce(buf, group=group)
    return buf.bool() if is_bool else buf


def gather_walkers(mesh, local: torch.Tensor, parts: int = 1) -> torch.Tensor:
    """The reverse of ``shard_walkers``: the global [W, ...] on every rank."""
    index, count = walker_rank(mesh)
    # the walker blocks are replicated over 'd': one 'd' rank writes each
    return _gather(local, count, index, None, data_rank(mesh)[0] == 0, parts)


def gather_data(mesh, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Concatenate the blocks of the ranks of 'd' along ``dim`` (a
    contiguous tensor: a reduction over a strided one may add in another
    order)."""
    index, count = data_rank(mesh)
    x = local.movedim(dim, 0)
    out = _gather(x, count, index, mesh.get_group(DATA), True)
    return out.movedim(0, dim).contiguous()


def gather_all(mesh, local: torch.Tensor) -> torch.Tensor:
    """[K, C, ...] from each rank's [K/|walker axes|, C/|d|, ...] block:
    the leading axis split over the walker axes, the second over 'd'."""
    wi, wn = walker_rank(mesh)
    di, dn = data_rank(mesh)
    k, c = local.shape[:2]
    is_bool = local.dtype == torch.bool
    x = local.to(torch.uint8) if is_bool else local
    buf = x.new_zeros((wn * k, dn * c) + tuple(x.shape[2:]))
    buf[wi * k:(wi + 1) * k, di * c:(di + 1) * c] = x
    dist.all_reduce(buf)
    return buf.bool() if is_bool else buf


def barrier(mesh) -> None:
    """Every rank waits here for the others (an all_reduce on the rank's
    device, read back on the host)."""
    t = torch.zeros(1, device=mesh_device(mesh))
    dist.all_reduce(t)
    float(t)


def sharded_batched_log_prob(log_prob_fn, mesh):
    """Batched log-prob of this rank's walker-axes block [W_local, D], with
    the block split once more over 'd' (the walkers are split over every
    dim): each rank evaluates ``log_prob_fn`` on its sub-block and the
    values are gathered over 'd'. Pass it to ``EnsembleSampler(mesh=...)``.
    """
    index, count = data_rank(mesh)

    def batched(walkers: torch.Tensor) -> torch.Tensor:
        (lo, hi), = _bounds(walkers.shape[0], index, count)
        return gather_data(mesh, log_prob_fn(walkers[lo:hi]))

    return batched


class _ShardedChi2(torch.autograd.Function):
    """chi^2 of delta [W, N] (the same on every rank of 'd') from this
    rank's slab of L^-1: its rows' share by the chi^2 kernel's row-block
    entry, summed over 'd'. The backward forms this rank's share of the
    delta-gradient, 2 g (delta L_b^T) L_b, and sums it over 'd', as JAX's
    transpose of a shard_map input that is not split over 'd' does: a
    plain all_reduce would leave each rank only its own rows' share, a
    differentiable one would count the gradient |d| times."""

    @staticmethod
    def forward(ctx, block, delta, group):
        ctx.save_for_backward(delta)
        ctx.block, ctx.group = block, group
        out = (whitened_chi2_rows(block, delta) if block.rows
               else delta.new_zeros(delta.shape[0]))
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        (delta,) = ctx.saved_tensors
        grad = (whitened_chi2_grad(ctx.block.slab, delta, g) if ctx.block.rows
                else torch.zeros_like(delta))
        dist.all_reduce(grad, group=ctx.group)
        return None, grad, None


def data_sharded_chi2(linv, mesh, dtype=torch.float32):
    """chi^2(delta) = ||L^-1 delta||^2 with L^-1's rows split over 'd': this
    rank keeps only its slab L^-1[r0:r1, :r1] on its device and forms its
    rows' share; the shares are summed over 'd'. The blocks split the
    triangle by equal work (``row_blocks``), not by equal rows, so that no
    rank waits on another; the sum is the same chi^2. The slab is kept as a
    ``RowBlock``, so that the row-block kernel splits it into its TF32
    halves once, at its first launch, and not at every call.

    ``linv`` [N, N] lower-triangular (numpy or tensor); returns
    ``chi2(delta [W_local, N]) -> [W_local]``, differentiable in delta.
    """
    linv = np.asarray(linv.detach().cpu() if isinstance(linv, torch.Tensor) else linv)
    index, count = data_rank(mesh)
    cuts = row_blocks(linv.shape[0], count)
    r0, r1 = cuts[index], cuts[index + 1]
    slab = torch.as_tensor(np.ascontiguousarray(linv[r0:r1, :r1]), device=mesh_device(mesh))
    block = RowBlock(slab.to(dtype))
    group = mesh.get_group(DATA)

    def chi2(delta: torch.Tensor) -> torch.Tensor:
        return _ShardedChi2.apply(block, delta, group)

    chi2.rows = (r0, r1)
    return chi2
