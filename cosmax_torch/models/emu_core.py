"""Build-time Chebyshev emulator machinery (counterpart of
``cosmax/models/emu_core.py``).

The build half is f64 numpy, ported nearly verbatim: Chebyshev nodes and
barycentric weights, the content-addressed on-disk table cache, the
truncated-SVD rank factorisation and the Tucker compression with its
composed end-to-end verification. Node tables are evaluated by the
port's own torch code in float64 on the CPU, whatever the runtime
device and dtype: an f32 solve leaves rounding noise above the
truncation tolerance of the small radiation-delta tables, and the rank
selection would then chase noise (the reference's ``f64_build``
rationale).

The runtime half is torch, batched over walkers: ``bary_vector`` and
``coeff_contract``, for the ``exact``, ``tucker`` and ``tt``
representations (the tensor train, which grids with three or more axes
take: w0wacdm). ``delta_subspace`` is not ported: only the reference's
retired fs8 emulator used it (ROADMAP.md, "Do not port").
"""

import hashlib
import os
import tempfile
from itertools import permutations
from pathlib import Path

import numpy as np
import torch

# generous default domains covering every preset's prior box
DOMAINS = {
    "Om": (0.03, 0.75),
    "w0": (-3.2, 0.6),
    "wa": (-3.5, 2.6),
}

# Radiation linearisation point of the chi^2 emulators: Or = orh2 / h^2
# tops out around 1.7e-4 over every preset's H0 box, so a secant through
# (0, OR_REF) brackets the realistic range.
OR_REF = 2e-4

MODEL_PARAMS = {
    "lcdm": ("Om",),
    "wcdm": ("Om", "w0"),
    "wzcdm": ("Om", "w0"),
    "w0wacdm": ("Om", "w0", "wa"),
}

# Bytes of the largest temporary of a batched tensor-train sweep; its
# walkers run in chunks under it (as the per-term path's terms do).
TT_TEMP_BYTES = 256 << 20


def cheb_nodes(n, lo, hi):
    """Chebyshev-Gauss-Lobatto nodes on [lo, hi], ascending, f64."""
    t = np.cos(np.pi * np.arange(n) / (n - 1))[::-1]
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * t


def bary_weights(n):
    w = np.ones(n)
    w[1::2] = -1.0
    w[0] *= 0.5
    w[-1] *= 0.5
    return w


def flatten_grid(axes):
    grids = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grids], axis=1)


def bary_vector(x: torch.Tensor, nodes: torch.Tensor, bw: torch.Tensor) -> torch.Tensor:
    """Barycentric interpolation weights at walker points ``x`` [W] on
    ``nodes`` [n] -> [W, n]; a point within 1e-14 of a node gets the
    one-hot row of that node."""
    diff = x[:, None] - nodes
    near = diff.abs() < 1e-14
    safe = torch.where(near, torch.ones_like(diff), diff)
    num = bw / safe
    w = num / num.sum(dim=-1, keepdim=True)
    return torch.where(near.any(dim=-1, keepdim=True), near.to(w.dtype), w)


def bary_vector_np(x, nodes):
    """f64 numpy barycentric weight vector (build-time reference-point
    evaluation)."""
    bw = bary_weights(len(nodes))
    diff = np.asarray(x, np.float64) - nodes
    if np.any(diff == 0.0):
        return (diff == 0.0).astype(np.float64)
    num = bw / diff
    return num / num.sum()


# ---------------------------------------------------------------------------
# content-addressed on-disk table cache

_PKG = Path(__file__).resolve().parents[1]

# The port's numeric-code files whose behaviour the node tables depend
# on. Their bytes are folded into every disk-cache key, so any edit to
# them invalidates cached tables. Later slices add theirs.
SOLVER_SOURCES = (
    "models/background.py",
    "models/distances.py",
    "ops/quadrature.py",
    "likelihoods/bao.py",
    "likelihoods/sn.py",
    "likelihoods/cc.py",
    "likelihoods/quasars.py",
    "likelihoods/fs8.py",
    "models/growth.py",
    "ops/ode.py",
    "models/emu_core.py",
    "models/linear_chi2.py",
)
_SOURCE_HASH = None

# Environment variable naming the table-cache directory; "", "0" or
# "off" disable the cache. The default lies in the checkout's ignored
# build directory, apart from the JAX package's cache.
TABLE_CACHE_ENV = "COSMAX_TORCH_TABLE_CACHE"
DEFAULT_TABLE_CACHE = _PKG.parent / "build" / "cosmax_torch_tables"


def solver_source_hash():
    global _SOURCE_HASH
    if _SOURCE_HASH is None:
        h = hashlib.sha256()
        for rel in SOLVER_SOURCES:
            h.update((_PKG / rel).read_bytes())
        _SOURCE_HASH = h.hexdigest()
    return _SOURCE_HASH


def table_cache_path(kind, key):
    """On-disk location of a build table, or None when the cache is off.

    A table is a pure function of its key and the solver sources, so it
    is shared by the tests, the CLI and ``chip_smoke.py``.
    """
    root = os.environ.get(TABLE_CACHE_ENV, str(DEFAULT_TABLE_CACHE))
    if root in ("", "0", "off"):
        return None
    h = hashlib.sha256()
    h.update(solver_source_hash().encode())
    h.update(kind.encode())
    h.update(repr(key).encode())
    try:
        os.makedirs(root, exist_ok=True)
    except OSError:
        return None
    return os.path.join(root, h.hexdigest() + ".npy")


def table_cached(kind, key, build):
    """Run ``build()`` through the on-disk table cache."""
    path = table_cache_path(kind, key)
    if path is not None and os.path.exists(path):
        try:
            return np.load(path)
        except (OSError, ValueError):
            pass  # torn or corrupt file: rebuild and overwrite
    out = build()
    if path is not None:
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".npy.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.save(f, out)
            os.replace(tmp, path)  # atomic against concurrent writers
        except OSError:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


# ---------------------------------------------------------------------------
# rank factorisation


def svd_rank_factor(stacked, tol):
    """Truncated f64 SVD of a stacked [M, K] table at absolute
    elementwise tolerance ``tol`` -> (A [M, R], B [R, K]); B has
    orthonormal rows."""
    u, s, vt = np.linalg.svd(stacked, full_matrices=False)
    noise = s <= 2e-8 * s[0]
    rank = int(np.argmax(noise)) if noise.any() else s.size
    rank = max(rank, 1)
    while (
        rank < s.size
        and np.max(np.abs((u[:, :rank] * s[:rank]) @ vt[:rank] - stacked)) > tol
    ):
        rank += 1
    return u[:, :rank] * s[:rank], vt[:rank]


# ---------------------------------------------------------------------------
# coefficient-table compression with composed end-to-end verification


def composed_err(rec, proj64, ref64):
    """Max elementwise error of a reconstructed coefficient table in the
    caller's data space: |rec @ proj - ref|."""
    return np.max(np.abs(rec.reshape(-1, rec.shape[-1]) @ proj64 - ref64))


def tucker(table, node_shape, tol, proj, ref):
    """HOSVD-compress ``table`` [*node_shape, R] along the parameter axes
    (reference ``emu_core.tucker``): per-axis ranks start at each mode
    unfolding's spectral noise floor and grow, largest discarded
    singular value first, until the Tucker reconstruction expanded
    through the caller's basis ``proj`` [R, N] matches the caller's
    data-space table ``ref`` [M, N] to ``tol`` elementwise. Returns
    ``(factors [n_i, r_i] list, core)``, or ``(None, table)`` when
    compression would not pay."""
    k = len(node_shape)
    tab64 = np.asarray(table, np.float64)
    proj64 = np.asarray(proj, np.float64)
    ref64 = np.asarray(ref, np.float64)

    svds = []
    for ax in range(k):
        mat = np.moveaxis(tab64, ax, 0).reshape(node_shape[ax], -1)
        u, s, _ = np.linalg.svd(mat, full_matrices=False)
        noise = s <= 1e-7 * s[0]
        r = int(np.argmax(noise)) if noise.any() else s.size
        svds.append((u, s, max(r, 1)))

    def reconstruct(ranks):
        core = tab64
        for ax in range(k):
            u = svds[ax][0][:, : ranks[ax]]
            core = np.moveaxis(np.tensordot(u.T, np.moveaxis(core, ax, 0), axes=1), 0, ax)
        rec = core
        for ax in range(k):
            u = svds[ax][0][:, : ranks[ax]]
            rec = np.moveaxis(np.tensordot(u, np.moveaxis(rec, ax, 0), axes=1), 0, ax)
        return core, rec

    ranks = [r for _, _, r in svds]
    while True:
        core, rec = reconstruct(ranks)
        if composed_err(rec, proj64, ref64) <= tol:
            break
        growable = [ax for ax in range(k) if ranks[ax] < node_shape[ax]]
        if not growable:
            break
        ax = max(
            growable,
            key=lambda a: svds[a][1][ranks[a]] if ranks[a] < svds[a][1].size else -np.inf,
        )
        ranks[ax] += 1

    if np.prod(ranks) * 2 > np.prod(node_shape):
        return None, tab64
    return [svds[ax][0][:, : ranks[ax]] for ax in range(k)], core


def tt(table, node_shape, tol, proj, ref):
    """TT-SVD (tensor train) of ``table`` [*node_shape, R] along the
    parameter axes, for grids with three or more of them (reference
    ``emu_core.tt``). Evaluation sweeps v <- v (w_i . G_i) through
    [r_{i-1}, n_i, r_i] cores, so its cost is linear in the number of
    axes where Tucker's is their product.

    The axis order is chosen first, from singular-value-only estimates of
    every single-axis and axis-pair unfolding; then the best order is
    built under the composed verification of :func:`tucker`: (1) a
    global relative truncation eps halved from 1e-7 until the build
    verifies, (2) a per-bond binary search for the smallest rank that
    still verifies. Returns ``(perm, cores, tail)`` (f64 numpy), or None
    when ``tol`` is unreachable or compression would not pay.

    The SVD of each sequential unfolding depends only on the ranks of the
    bonds before it, so it is computed once per such prefix: the search
    rebuilds from the memo, with the reference's numbers."""
    k = len(node_shape)
    tab0 = np.asarray(table, np.float64)
    nz = tab0.shape[-1]
    proj64 = np.asarray(proj, np.float64)
    ref64 = np.asarray(ref, np.float64)

    def est_rank(axes_front):
        mat = np.transpose(
            tab0,
            tuple(axes_front) + tuple(a for a in range(k) if a not in axes_front) + (k,),
        ).reshape(int(np.prod([node_shape[a] for a in axes_front])), -1)
        s = np.linalg.svd(mat, compute_uv=False)
        return max(int(np.sum(s > 1e-7 * s[0])), 1)

    singles = {(a,): est_rank((a,)) for a in range(k)}
    pairs = {}
    best_perm, best_cost = None, np.inf
    for perm in permutations(range(k)):
        bonds = []
        for cut in range(1, k):
            front = tuple(sorted(perm[:cut]))
            if len(front) == 1:
                bonds.append(singles[front])
            else:
                if front not in pairs:
                    pairs[front] = est_rank(front)
                bonds.append(pairs[front])
        n = [node_shape[a] for a in perm]
        r_last = min(bonds[-1] * n[-1], nz)  # final bond into the tail
        cost = 2 * n[0] * bonds[0] + 2 * r_last * nz
        for i in range(1, k):
            r_in = bonds[i - 1]
            r_out = bonds[i] if i < k - 1 else r_last
            cost += 2 * n[i] * r_in * r_out
        if cost < best_cost:
            best_perm, best_cost = perm, cost

    perm = best_perm
    tab64 = np.ascontiguousarray(np.transpose(tab0, perm + (k,)))
    shape_p = [node_shape[a] for a in perm]
    svd_memo = {}

    def build(eps, caps):
        cores = []
        carry = tab64.reshape(shape_p[0], -1)
        r_prev = 1
        prefix = ()
        for i in range(k):
            if prefix not in svd_memo:
                mat = carry if i == 0 else carry.reshape(r_prev * shape_p[i], -1)
                svd_memo[prefix] = np.linalg.svd(mat, full_matrices=False)
            u, s, vt = svd_memo[prefix]
            r = max(int(np.sum(s > eps * s[0])), 1)
            if caps is not None:
                r = min(r, caps[i])
            if i == 0:
                cores.append(u[:, :r])  # [n1, r1]
            else:
                cores.append(u[:, :r].reshape(r_prev, shape_p[i], r))
            carry = s[:r, None] * vt[:r]
            r_prev = r
            prefix += (r,)
        return cores, carry.reshape(r_prev, nz)

    inv_perm = tuple(np.argsort(perm))

    def passes(cores, tail):
        rec = cores[0]
        for g in cores[1:]:
            rec = np.tensordot(rec, g, axes=(rec.ndim - 1, 0))
        rec = np.tensordot(rec, tail, axes=(rec.ndim - 1, 0))
        rec = np.transpose(rec, inv_perm + (k,))
        return composed_err(rec, proj64, ref64) <= tol

    eps = 1e-7
    for _ in range(12):
        cores, tail = build(eps, None)
        if passes(cores, tail):
            break
        eps *= 0.5
    else:
        return None

    ranks = [c.shape[-1] for c in cores]
    for i in range(k):
        lo, hi = 1, ranks[i]
        while lo < hi:
            mid = (lo + hi) // 2
            trial = list(ranks)
            trial[i] = mid
            if passes(*build(eps, trial)):
                hi = mid
            else:
                lo = mid + 1
        ranks[i] = lo
    cores, tail = build(eps, ranks)
    if not passes(cores, tail):  # defensive: keep the verified build
        cores, tail = build(eps, None)

    n_stored = sum(c.size for c in cores) + tail.size
    if n_stored * 2 > tab64.size:
        return None
    return tuple(int(a) for a in perm), cores, tail


def seq_contract_flops(shape):
    """Flops of sequentially contracting leading axes off ``shape``."""
    return sum(2 * int(np.prod(shape[i:])) for i in range(len(shape) - 1))


def eval_flops(rep):
    """Exact per-eval flop count of :func:`coeff_contract` on a tagged rep."""
    if rep[0] == "exact":
        return seq_contract_flops(rep[1].shape)
    if rep[0] == "tucker":
        _, factors, core = rep
        return sum(2 * u.shape[0] * u.shape[1] for u in factors) + seq_contract_flops(core.shape)
    _, _, cores, tail = rep  # tt
    total = 2 * cores[0].shape[0] * cores[0].shape[1]
    for g in cores[1:]:
        r_prev, n, r = g.shape
        total += 2 * n * r_prev * r + 2 * r_prev * r
    return total + 2 * tail.shape[0] * tail.shape[1]


def compress(table, node_shape, tol, proj, ref):
    """The cheapest verified representation of the coefficient table by
    exact eval flop count: a tensor train (three or more parameter axes
    only), Tucker, or the exact table when Tucker would not pay. Returns
    a tagged rep (f64 numpy) consumed by :func:`coeff_contract`."""
    candidates = []
    if len(node_shape) >= 3:
        rep_tt = tt(table, node_shape, tol, proj, ref)
        if rep_tt is not None:
            candidates.append(("tt",) + rep_tt)
    factors, core = tucker(table, node_shape, tol, proj, ref)
    if factors is None:
        candidates.append(("exact", core))
    else:
        candidates.append(("tucker", factors, core))
    return min(candidates, key=eval_flops)


def coeff_contract(weights, rep):
    """Contract per-axis barycentric weights ([W, n_i] each) against a
    tagged representation whose arrays are tensors -> [W, R]."""
    kind = rep[0]
    if kind == "exact":
        out = rep[1]
        for i, w in enumerate(weights):
            # first axis: [W, n] x [n, ...]; later axes: batched over W
            out = (
                torch.tensordot(w, out, dims=([1], [0])) if i == 0
                else torch.einsum("wn,wn...->w...", w, out)
            )
        return out
    if kind == "tucker":
        _, factors, core = rep
        out = None
        for w, u in zip(weights, factors):
            wp = w @ u  # [W, r_i]
            out = (
                torch.tensordot(wp, core, dims=([1], [0])) if out is None
                else torch.einsum("wr,wr...->w...", wp, out)
            )
        return out
    _, perm, cores, tail = rep  # tt, axes in build order
    wp = [weights[a] for a in perm]
    # the largest [W, r_prev, r] temporary bounds the walkers of a chunk
    per_walker = max([g.shape[0] * g.shape[2] for g in cores[1:]] + [tail.shape[1]])
    chunk = max(1, TT_TEMP_BYTES // (tail.element_size() * per_walker))
    parts = []
    for s in range(0, wp[0].shape[0], chunk):
        v = wp[0][s:s + chunk] @ cores[0]  # [W, r1]
        for w, g in zip(wp[1:], cores[1:]):
            m = torch.einsum("wn,pnr->wpr", w[s:s + chunk], g)  # [W, r_prev, r]
            v = torch.einsum("wp,wpr->wr", v, m)
        parts.append(v @ tail)
    return parts[0] if len(parts) == 1 else torch.cat(parts)
