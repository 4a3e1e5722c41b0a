"""Download hooks for the large systematic covariances stripped from
the reference checkout (reference .MISSING_LARGE_BLOBS:1-5); the
counterpart of ``cosmax/data/fetch.py``, over the store that the port's
loaders read.

The four matrices exist in public data releases; this module downloads
them, converts each release format into the array the loaders expect
(``cosmax_torch/data/loaders.py``, ``load_sn``), and patches the existing
store bundle in place — after which the affected datasets load their
full covariance (``synthetic_cov=False``) and the published rows in
BASELINE.md become verifiable.

Usage (needs network)::

    python -m cosmax_torch.data.fetch            # all four
    python -m cosmax_torch.data.fetch pantheon_plus des5y

Release formats handled:

* ``nfirst`` — first whitespace token is N, followed by N*N floats
  (Pantheon+SH0ES ``Pantheon+SH0ES_STAT+SYS.cov``, reference consumer
  y2022pantheonSHOES/data.py:9-18; DES-SN5YR ``STAT+SYS.txt.gz``,
  y2024DES/data.py:18-20; Pantheon 2018 ``sys_full_long.txt``,
  y2018pantheon/data.py:17)
* ``dense`` — plain N x N whitespace/tab table (SCP Union2.1
  ``SCPUnion2.1_covmat_sys.txt``, y2011union2/data.py:9-19)

Per-dataset conversion to the store keys:

* ``pantheon_plus``: the release matrix is stat+sys in the SH0ES frame
  and 1701-row release order = store row order -> saved as ``cov``.
* ``des5y``: the release matrix is saved VERBATIM (z-sorted) as
  ``cov_sys``. The reference consumer adds diag(MUERR_FINAL^2) on top
  of its same-named ``covariance_stat_sys`` file
  (y2024DES/data.py:18-20), and the port's loader reproduces exactly
  that (loaders.py re-adds diag(mu_err^2)) — so parity with the
  reference pipeline is preserved whatever the release file's own
  diagonal convention is. The store is z-sorted (ingest_des5y), so the
  companion hubble-diagram file is fetched to compute the argsort(zHD)
  permutation (and the sorted zHD are cross-checked against the
  bundle).
* ``union21``: full systematic covariance in release row order; the
  store is z-sorted, so the companion mu-vs-z table provides the
  permutation, cross-checked the same way -> saved as ``cov``.
* ``pantheon18``: systematics-only matrix in lcparam row order; the
  store is z-sorted (ingest_pantheon18 / y2018pantheon/data.py:20-29),
  so the companion lcparam table provides the argsort(zcmb)
  permutation, cross-checked against the bundle -> ``cov_sys`` (the
  loader re-adds diag(dmb^2), loaders.py:232).

Integrity: each payload's size must match the published dataset
(_EXPECTED_N); gross asymmetry is refused as format drift; the sha256
of every download is printed and recorded in the bundle
(``cov_fetch_sha256``) and verified against ``_SHA256`` when a pin is
known (the pins start unset — populate them on first verified
contact). After patching, the published chi^2 at the
published best-fit point is re-evaluated (``postcheck``): a gross
mismatch (orders beyond rounding error) aborts with a convention
diagnosis instead of silently skewing every downstream fit.
"""

import argparse
import gzip
import hashlib
import os
import sys

import numpy as np

from cosmax_torch.data.ingest import STORE

# Published dataset sizes (reference loaders): any other payload shape
# is release-format drift and must fail loudly, not parse quietly.
_EXPECTED_N = {
    "pantheon_plus": 1701,  # y2022pantheonSHOES/data.py:9-18
    "des5y": 1829,  # y2024DES/data.py:18-20
    "union21": 580,  # y2011union2/data.py:9-19
    "pantheon18": 1048,  # y2018pantheon/data.py:17
}

# sha256 pins of the release payloads. They start unset (None = print +
# record, don't verify); populate them on first verified contact with the
# releases and any later silent re-upload will be refused.
_SHA256 = {
    "pantheon_plus": None,
    "des5y": None,
    "union21": None,
    "pantheon18": None,
}

# Published (params -> chi2) anchors re-evaluated after a patch: the
# strongest end-to-end check of the covariance convention (BASELINE.md
# single-probe rows; chi2 at the published rounded medians matches the
# published chi2 to ~0.1 on every verifiable dataset).
_POSTCHECKS = {
    "pantheon_plus": (
        "sn.pantheon", {"M": -19.351, "Om": 0.332}, 1402.92,
    ),  # sn/pantheon.py:191-208
    "des5y": (
        "sn.des5y", {"dM": 0.022, "Om": 0.352}, 1640.08,
    ),  # sn/des5y.py:175-227
}

_URLS = {
    "pantheon_plus": (
        "https://raw.githubusercontent.com/PantheonPlusSH0ES/DataRelease/"
        "main/Pantheon%2B_Data/4_DISTANCES_AND_COVAR/"
        "Pantheon%2BSH0ES_STAT%2BSYS.cov",
        "nfirst",
        None,
    ),
    "des5y": (
        "https://raw.githubusercontent.com/des-science/DES-SN5YR/main/"
        "4_DISTANCES_COVMAT/STAT%2BSYS.txt.gz",
        "nfirst",
        # companion: zHD column -> sort permutation
        "https://raw.githubusercontent.com/des-science/DES-SN5YR/main/"
        "4_DISTANCES_COVMAT/DES-SN5YR_HD.csv",
    ),
    "union21": (
        "https://supernova.lbl.gov/Union/figures/SCPUnion2.1_covmat_sys.txt",
        "dense",
        "https://supernova.lbl.gov/Union/figures/SCPUnion2.1_mu_vs_z.txt",
    ),
    "pantheon18": (
        "https://raw.githubusercontent.com/dscolnic/Pantheon/master/"
        "sys_full_long.txt",
        "nfirst",
        # companion: lcparam zcmb column -> sort permutation (the sys
        # matrix is in lcparam row order; the store is z-sorted)
        "https://raw.githubusercontent.com/dscolnic/Pantheon/master/"
        "lcparam_full_long.txt",
    ),
}


def parse_redshifts(raw: bytes, dataset: str) -> np.ndarray:
    """Extract the redshift column (release row order) from a dataset's
    companion table."""
    text = raw.decode("utf-8", errors="replace")
    if dataset == "des5y":
        # csv with a zHD column
        rows = [ln.split(",") for ln in text.splitlines() if ln.strip()]
        col = [c.strip() for c in rows[0]].index("zHD")
        return np.array([float(r[col]) for r in rows[1:]])
    if dataset == "union21":
        # '#'-commented, tab-separated: name, z, mu, err[, p_host]
        vals = [
            ln.split("\t")[1]
            for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")
        ]
        return np.array([float(v) for v in vals])
    if dataset == "pantheon18":
        # lcparam_full_long.txt: '#name zcmb zhel dz mb ...' header,
        # whitespace-separated; zcmb is column 1
        vals = [
            ln.split()[1]
            for ln in text.splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")
        ]
        return np.array([float(v) for v in vals])
    raise ValueError(f"no companion parser for {dataset!r}")


def parse_cov(raw: bytes, fmt: str) -> np.ndarray:
    """Parse a downloaded covariance in one of the release formats."""
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    # whitespace tokenisation, not loadtxt: the nfirst layout has a
    # ragged first row (the N header) that loadtxt refuses
    vals = np.array(raw.split(), dtype=np.float64)
    if fmt == "nfirst":
        n = int(round(vals[0]))
        body = vals[1:]
        if body.size != n * n:
            raise ValueError(f"expected {n}*{n} values, got {body.size}")
        return body.reshape(n, n)
    if fmt == "dense":
        n = int(round(np.sqrt(vals.size)))
        if n * n != vals.size:
            raise ValueError(f"not a square table: {vals.size} values")
        return vals.reshape(n, n)
    raise ValueError(f"unknown format {fmt!r}")


def patch_store(
    dataset: str,
    cov: np.ndarray,
    raw_z: np.ndarray = None,
    store: str = None,
    provenance: dict = None,
) -> str:
    """Convert ``cov`` to the loader's store key and rewrite the npz
    bundle. ``raw_z`` is the release-row-order redshift column for the
    z-sorted datasets (des5y, union21): it yields the permutation and
    an integrity cross-check against the bundle. Pure file
    transformation — unit tested offline (tests/test_fetch.py)."""
    store = store or STORE
    path = os.path.join(store, f"{dataset}.npz")
    b = dict(np.load(path, allow_pickle=False))
    cov = np.asarray(cov, dtype=np.float64)
    # release matrices are symmetric up to print truncation; anything
    # grossly asymmetric is a mis-parsed / reformatted payload
    scale = float(np.max(np.abs(cov))) or 1.0
    asym = float(np.max(np.abs(cov - cov.T)))
    if asym > 1e-6 * scale:
        raise ValueError(
            f"{dataset}: downloaded matrix is asymmetric "
            f"(max |C - C^T| = {asym:.3g} vs scale {scale:.3g}) — "
            "release format drift; refusing to patch"
        )
    cov = 0.5 * (cov + cov.T)

    def zsort(bundle_z):
        if raw_z is None:
            raise ValueError(
                f"{dataset} store rows are z-sorted; the companion "
                "redshift table is required to permute the covariance"
            )
        # kind="stable" matches the ingest sorts: all three z-sorted
        # datasets contain duplicate redshifts, and the default
        # introsort's tie order is implementation-defined — a fetch
        # run under a different numpy than the ingest would otherwise
        # pair covariance rows with the wrong same-z supernova, which
        # the sorted-z cross-check below cannot detect
        order = np.argsort(np.asarray(raw_z, dtype=np.float64), kind="stable")
        if not np.allclose(np.asarray(raw_z)[order], bundle_z, atol=1e-8):
            raise ValueError(
                f"{dataset}: sorted release redshifts do not match the "
                "store bundle — release row order has changed upstream"
            )
        return cov[np.ix_(order, order)]

    if dataset == "pantheon_plus":
        _check_shape(cov, len(b["m_b_corr"]))
        b["cov"] = cov
    elif dataset == "des5y":
        _check_shape(cov, len(b["mu_err"]))
        # Stored VERBATIM (z-sorted): the reference adds
        # diag(MUERR_FINAL^2) on top of its same-named
        # covariance_stat_sys file (y2024DES/data.py:18-20) and the
        # loader reproduces that, so storing the download unmodified
        # preserves reference parity regardless of the release file's
        # own diagonal convention. (Subtracting diag(mu_err^2) here —
        # the previous behaviour — assumed the release includes it,
        # which is unverifiable offline and would silently skew every
        # des5y chi2 if wrong; postcheck() now validates the published
        # chi2 after the patch either way.)
        b["cov_sys"] = zsort(b["z_hd"])
    elif dataset == "union21":
        _check_shape(cov, len(b["mu"]))
        b["cov"] = zsort(b["z"])
    elif dataset == "pantheon18":
        _check_shape(cov, len(b["mb"]))
        # the release matrix follows lcparam row order; the store (and
        # the reference consumer, y2018pantheon/data.py:20-29) is
        # z-sorted, so the covariance must be permuted with it
        b["cov_sys"] = zsort(b["z_cmb"])
    else:
        raise ValueError(f"unknown dataset {dataset!r}")

    for k, v in (provenance or {}).items():
        b[k] = np.asarray(v)
    from cosmax_torch.utils.io import atomic_savez

    # atomic: a crash mid-patch must not corrupt the data store
    atomic_savez(path, compressed=True, **b)
    # a long-lived process must see the patched bundle on next load
    from cosmax_torch.data.loaders import _bundle

    _bundle.cache_clear()
    return path


def _check_shape(cov, n):
    if cov.shape != (n, n):
        raise ValueError(f"covariance is {cov.shape}, dataset has {n} rows")


def fetch(
    dataset: str,
    store: str = None,
    timeout: float = 120.0,
    run_postcheck: bool = True,
    device="cuda",
) -> str:
    """Download one dataset's covariance and patch its store bundle.

    Full pipeline: download -> sha256 (verify against _SHA256 when
    pinned, always recorded) -> parse (format + published-size check)
    -> permute/patch -> published-chi2 postcheck. Every step fails
    loudly on drift rather than patching a skewed covariance."""
    from urllib.request import urlopen

    url, fmt, companion = _URLS[dataset]
    print(f"fetching {dataset}: {url}")
    with urlopen(url, timeout=timeout) as r:
        raw = r.read()
    digest = hashlib.sha256(raw).hexdigest()
    pin = _SHA256.get(dataset)
    if pin is not None and digest != pin:
        raise ValueError(
            f"{dataset}: payload sha256 {digest} != pinned {pin} — "
            "the release file changed upstream; refusing to patch"
        )
    print(f"  sha256 {digest}" + ("" if pin else " (no pin yet — recorded)"))
    cov = parse_cov(raw, fmt)
    n_expect = _EXPECTED_N[dataset]
    if cov.shape[0] != n_expect:
        raise ValueError(
            f"{dataset}: payload is {cov.shape[0]}^2, published dataset "
            f"is {n_expect}^2 — release format drift; refusing to patch"
        )
    raw_z = None
    if companion is not None:
        with urlopen(companion, timeout=timeout) as r:
            raw_z = parse_redshifts(r.read(), dataset)
    path = patch_store(
        dataset, cov, raw_z=raw_z, store=store,
        provenance={"cov_fetch_sha256": digest, "cov_fetch_url": url},
    )
    print(f"patched {path} ({cov.shape[0]}^2 covariance)")
    if run_postcheck and store is None:
        postcheck(dataset, device=device)
    return path


def postcheck(dataset: str, atol: float = 2.0, device="cuda") -> float:
    """Re-evaluate the published chi^2 at the published best-fit point
    on the freshly-patched covariance (default store). A mismatch far
    beyond rounding error means the covariance convention is wrong —
    e.g. a diag(mu_err^2) double-count shifts the des5y chi2 by
    hundreds — so it aborts with a diagnosis instead of letting every
    downstream fit skew silently. Evaluated through the port's preset on
    ``device`` (the card unless the caller asks for the CPU). Returns the
    chi2 difference."""
    if dataset not in _POSTCHECKS:
        return 0.0
    import torch

    from cosmax_torch.configs import get_preset

    preset_name, params, chi2_pub = _POSTCHECKS[dataset]
    fit = get_preset(preset_name, "lcdm", device=device)
    x = np.asarray([params[n] for n in fit.spec.names], dtype=np.float64)
    theta = torch.as_tensor(x[None, :], device=fit.device).to(fit.dtype)
    with torch.no_grad():
        chi2 = float(sum(v[0] for v in fit.chi2_breakdown()(theta).values()))
    diff = chi2 - chi2_pub
    print(
        f"  postcheck {preset_name}: chi2 at published best fit = "
        f"{chi2:.2f} (published {chi2_pub:.2f}, diff {diff:+.2f})"
    )
    if abs(diff) > atol:
        raise ValueError(
            f"{dataset}: chi2 at the published best fit is {chi2:.2f}, "
            f"published {chi2_pub:.2f} (diff {diff:+.2f} > {atol}) — the "
            "patched covariance does not reproduce the reference "
            "pipeline. Most likely the release file's diagonal "
            "convention differs from the reference's "
            "covariance_stat_sys input (e.g. diag(mu_err^2) counted "
            "twice or missing). The bundle HAS been patched; inspect "
            "cov_fetch_sha256/url provenance and re-ingest if needed."
        )
    return diff


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="cosmax_torch.data.fetch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("datasets", nargs="*", default=None,
                   help=f"subset of {sorted(_URLS)} (default: all)")
    p.add_argument("--store", default=None, help="alternate store dir")
    p.add_argument("--device", default="cuda", help="torch device of the postcheck")
    args = p.parse_args(argv)
    names = args.datasets or sorted(_URLS)
    failures = []
    for name in names:
        if name not in _URLS:
            p.error(f"unknown dataset {name!r}; choose from {sorted(_URLS)}")
        try:
            fetch(name, store=args.store, device=args.device)
        except Exception as e:
            failures.append(name)
            print(f"FAILED {name}: {e}", file=sys.stderr)
    if failures:
        print(
            f"{len(failures)} fetch(es) failed ({', '.join(failures)}) — "
            "offline? The loaders keep their documented fallback "
            "(diagonal statistical covariance, synthetic_cov=True).",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
