"""Run a function on every rank of a new process group.

    results = spawn("pkg.module:function", world_size, backend="gloo",
                    device="cpu", args=(...))

starts ``world_size`` processes (``multiprocessing``'s spawn method, so a
worker imports only what the function's module imports), joins them
through a ``file://`` rendezvous in a temporary directory (no network
port), sets each rank's device and calls ``function(*args)`` in each.
Returns the ranks' return values (``torch.save``-able) in rank order.

``device``: ``"cpu"``; ``"cuda"``, rank r on ``cuda:r`` (NCCL's layout:
NCCL refuses two ranks on one card); or ``"cuda:<i>"``, every rank on that
card (gloo only). A rank that fails makes the call raise with its
traceback; the others are stopped. Nothing falls back to the CPU or to
fewer ranks.
"""

import importlib
import os
import tempfile
import time
import traceback

import torch

_BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def resolve_rank_device(device: str, rank: int, backend: str) -> torch.device:
    """The device of ``rank`` under the layout ``device`` (see above), set
    as the current device and recorded as the rank's (a mesh takes it)."""
    from cosmax_torch.device import resolve
    from cosmax_torch.parallel.mesh import set_rank_device

    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", rank)
        elif backend == "nccl":
            raise ValueError("NCCL takes one card a rank: pass device='cuda'")
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA tensors: pass device='cuda'")
    resolve(dev)  # raises when CUDA is asked for and absent
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)  # the context exists before the mesh
    set_rank_device(dev)
    return dev


def _worker(rank, world_size, backend, device, tmp, target, args, threads):
    import torch.distributed as dist

    out = os.path.join(tmp, f"rank{rank}.pt")
    try:
        if threads:
            torch.set_num_threads(threads)
        resolve_rank_device(device, rank, backend)
        dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous", rank=rank,
                                world_size=world_size)
        module, name = target.split(":")
        result = getattr(importlib.import_module(module), name)(*args)
        torch.save({"result": result}, out)
    except BaseException:
        torch.save({"error": traceback.format_exc()}, out)
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target: str, world_size: int, backend: str = "gloo", device: str = "cpu",
          args: tuple = (), timeout: float = 600.0, threads: int = None) -> list:
    """Run ``target`` ("module:function") on ``world_size`` ranks and return
    their results; ``threads`` sets each rank's torch and BLAS threads."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_worker, args=(r, world_size, backend, device, tmp, target,
                                                   tuple(args), threads))
                 for r in range(world_size)]
        # a rank's BLAS threads too (numpy reads them at import)
        saved = {k: os.environ.get(k) for k in _BLAS_THREADS}
        try:
            if threads:
                os.environ.update({k: str(threads) for k in _BLAS_THREADS})
            for p in procs:
                p.start()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(path) else {}
            if "error" in got:
                errors.append(f"rank {r}:\n{got['error']}")
            elif p.exitcode != 0 or "result" not in got:
                errors.append(f"rank {r}: exit code {p.exitcode} (timeout {timeout:g} s)")
            results.append(got.get("result"))
        if errors:
            raise RuntimeError(f"{target} on {world_size} {backend} ranks failed:\n"
                               + "\n".join(errors))
        return results
