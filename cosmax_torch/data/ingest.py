"""Build the data store from the public observational data files
(counterpart of ``cosmax/data/ingest.py``; the same bundles, written
into the store that the port's loaders read, ``loaders._STORE``).

Usage::

    python -m cosmax_torch.data.ingest --source /path/to/raw/checkout

The source layout is the public one documented per dataset below (the
same files the reference suite ships; all are published observational
data — Pantheon+/SH0ES, DES-SN5YR, Union3, Union2.1, Pantheon 2018,
DESI DR2 & SDSS DR16 BAO, Moresco cosmic chronometers, Lusso+2020
quasars, fsigma8 compilation). Each dataset is normalised into one
``.npz`` bundle in the store, so a fit has no runtime dependency on
pandas/CSV parsing or on the source checkout. pandas is imported by the
functions that read the CSV files, and only there.

Large systematic covariance matrices absent from the mounted source
(the reference's .MISSING_LARGE_BLOBS: Pantheon+ 1701^2, DES5Y sys,
Union2.1, Pantheon18 full) are recorded as unavailable; the loaders
then fall back to the statistical (diagonal) covariance and mark the
dataset ``synthetic_cov=True`` so parity tests know to skip chi^2
checks against published full-covariance results.
"""

import argparse
import io
import os
import zipfile

import numpy as np

from cosmax_torch.data.loaders import _STORE as STORE

QTY_CODES = {"DV_over_rs": 0, "DM_over_rs": 1, "DH_over_rs": 2}


def _save(name, **arrays):
    from cosmax_torch.utils.io import atomic_savez

    path = os.path.join(STORE, f"{name}.npz")
    atomic_savez(path, compressed=True, **arrays)
    sizes = {k: getattr(v, "shape", None) for k, v in arrays.items()}
    print(f"wrote {path}: {sizes}")


def _maybe(path):
    return path if os.path.exists(path) else None


def ingest_bao(src, dirname, outname, legend):
    """DESI DR2 (y2025BAO) / SDSS DR16 (y2020SDSSBAO) style: a csv of
    (z, value, quantity-string) plus a dense covariance."""
    import pandas as pd

    base = os.path.join(src, dirname, "raw-data")
    for suffix, tag in (("", ""), ("-comp", "_comp")):
        data_file = _maybe(os.path.join(base, f"data{suffix}.csv"))
        if data_file is None:
            continue
        df = pd.read_csv(data_file)
        cov = np.loadtxt(os.path.join(base, f"covariance{suffix}.txt"))
        qty = np.array([QTY_CODES[q] for q in df["quantity"]], dtype=np.int32)
        _save(
            f"{outname}{tag}",
            legend=np.array(legend),
            z=df["z"].to_numpy(np.float64),
            value=df["value"].to_numpy(np.float64),
            quantity=qty,
            cov=np.asarray(cov, dtype=np.float64),
        )


def _read_cov_column(path, column, n):
    import pandas as pd

    if path.endswith(".zip"):
        with zipfile.ZipFile(path) as zf:
            inner = zf.namelist()[0]
            with zf.open(inner) as fh:
                df = pd.read_csv(io.TextIOWrapper(fh))
    else:
        df = pd.read_csv(path, sep=None, engine="python")
    return df[column].to_numpy(np.float64).reshape((n, n))


def ingest_pantheon_plus(src):
    """Pantheon+SH0ES release (PantheonPlusSH0ES/DataRelease
    4_DISTANCES_AND_COVAR/Pantheon+SH0ES.dat). Stores the full table;
    the z>0.01 / calibrator cuts are applied by the loaders so both the
    SN-only and the SH0ES-anchored selections come from one bundle."""
    import pandas as pd

    base = os.path.join(src, "y2022pantheonSHOES", "raw-data")
    df = pd.read_csv(os.path.join(base, "distances.txt"), sep=" ")
    arrays = dict(
        z_hd=df["zHD"].to_numpy(np.float64),
        z_hel=df["zHEL"].to_numpy(np.float64),
        m_b_corr=df["m_b_corr"].to_numpy(np.float64),
        m_b_corr_err_diag=df["m_b_corr_err_DIAG"].to_numpy(np.float64),
        ceph_dist=df["CEPH_DIST"].to_numpy(np.float64),
        is_calibrator=df["IS_CALIBRATOR"].to_numpy(np.int32),
    )
    cov_file = _maybe(os.path.join(base, "covariance_stat_sys.txt"))
    if cov_file is not None:
        arrays["cov"] = _read_cov_column(cov_file, "cov_mu_shoes", len(df))
    _save("pantheon_plus", legend=np.array("Pantheon+ (2022)"), **arrays)


def ingest_des5y(src):
    """DES-SN5YR hubble diagram (des-science/DES-SN5YR 4_DISTANCES_COVMAT).
    Sorted by zHD as in the reference loader (y2024DES/data.py:24-31).

    The z-sorts here, in ingest_union21 and in ingest_pantheon18 are
    ``kind="stable"``: these tables contain duplicate redshifts, and
    data.fetch must later reproduce the exact row order from the
    release's own redshift column to align a downloaded covariance —
    the default introsort's tie order is numpy-implementation-defined,
    stable order is not. (chi^2 is invariant to the choice; the
    ingest/fetch AGREEMENT is what matters.)"""
    import pandas as pd

    base = os.path.join(src, "y2024DES", "raw-data")
    df = pd.read_csv(os.path.join(base, "distances.txt"))
    eff = int(np.round((1.0 - df["PROBCC_BEAMS"]).sum()))
    order = np.argsort(df["zHD"].to_numpy(np.float64), kind="stable")
    arrays = dict(
        z_hd=df["zHD"].to_numpy(np.float64)[order],
        z_hel=df["zHEL"].to_numpy(np.float64)[order],
        mu=df["MU"].to_numpy(np.float64)[order],
        mu_err=df["MUERR_FINAL"].to_numpy(np.float64)[order],
        effective_sample_size=np.int64(eff),
    )
    cov_file = _maybe(os.path.join(base, "covariance_stat_sys.txt.zip"))
    if cov_file is not None:
        arrays["cov_sys"] = _read_cov_column(cov_file, "cov_mu", len(df))[
            np.ix_(order, order)
        ]
    _save("des5y", legend=np.array(f"DES-SN5YR - effective: {eff} SNe"), **arrays)


def ingest_union3(src):
    """Union3 22-bin compression, sorted by z (y2023union3/data.py:12-20)."""
    import pandas as pd

    base = os.path.join(src, "y2023union3", "raw-data")
    df = pd.read_csv(os.path.join(base, "bins_union_3.csv"))
    n = len(df)
    cov = np.genfromtxt(os.path.join(base, "covariance.txt")).reshape(n, n)
    order = np.argsort(df["zcmb"].to_numpy(np.float64))
    _save(
        "union3",
        legend=np.array("Union3 - 22 Bins"),
        z_cmb=df["zcmb"].to_numpy(np.float64)[order],
        z_hel=df["zhel"].to_numpy(np.float64)[order],
        mu=df["mu"].to_numpy(np.float64)[order],
        cov=cov[np.ix_(order, order)],
    )


def ingest_union21(src):
    """Union2.1, sorted by z (y2011union2/data.py:12-20)."""
    import pandas as pd

    base = os.path.join(src, "y2011union2", "raw-data")
    df = pd.read_csv(os.path.join(base, "distances.txt"), sep=" ")
    order = np.argsort(df["z"].to_numpy(np.float64), kind="stable")
    arrays = dict(
        z=df["z"].to_numpy(np.float64)[order],
        mu=df["mu"].to_numpy(np.float64)[order],
        sigma_mu=df["sigma_mu"].to_numpy(np.float64)[order],
    )
    cov_file = _maybe(os.path.join(base, "covariance_stat_sys.txt"))
    if cov_file is not None:
        arrays["cov"] = np.loadtxt(cov_file, delimiter="\t")[np.ix_(order, order)]
    _save("union21", legend=np.array("Union2.1"), **arrays)


def ingest_pantheon18(src):
    """Pantheon 2018 (1048 SNe), sorted by zcmb (y2018pantheon/data.py:20-29)."""
    import pandas as pd

    base = os.path.join(src, "y2018pantheon", "raw-data")
    df = pd.read_csv(os.path.join(base, "mb.txt"), sep=" ")
    order = np.argsort(df["zcmb"].to_numpy(np.float64), kind="stable")
    arrays = dict(
        z_cmb=df["zcmb"].to_numpy(np.float64)[order],
        z_hel=df["zhel"].to_numpy(np.float64)[order],
        mb=df["mb"].to_numpy(np.float64)[order],
        dmb=df["dmb"].to_numpy(np.float64)[order],
    )
    cov_file = _maybe(os.path.join(base, "mb_covariance_sys.txt"))
    if cov_file is not None:
        n = len(df)
        arrays["cov_sys"] = (
            pd.read_csv(cov_file)["cov_mu"]
            .to_numpy(np.float64)
            .reshape((n, n))[np.ix_(order, order)]
        )
    _save("pantheon18", legend=np.array("Pantheon2018"), **arrays)
    # Binned variant (40 bins) with full systematic covariance.
    dfb = pd.read_csv(os.path.join(base, "mb_bins.txt"), sep=" ")
    nb = len(dfb)
    covb = np.loadtxt(os.path.join(base, "mb_bins_covariance_sys.txt"), skiprows=1)
    _save(
        "pantheon18_bins",
        legend=np.array("Pantheon2018 (binned)"),
        z_cmb=dfb["zcmb"].to_numpy(np.float64),
        z_hel=dfb["zhel"].to_numpy(np.float64),
        mb=dfb["mb"].to_numpy(np.float64),
        dmb=dfb["dmb"].to_numpy(np.float64),
        cov_sys=covb.reshape(nb, nb),
    )


def ingest_cc(src):
    """Moresco compilation: 33 H(z) points + systematic covariance
    components (IMF / stellar library / SPS), interpolated in z and
    combined as rank-one outer products exactly as the reference does
    (y2005cc/data.py:14-38, after gitlab.com/mmoresco/CCcovariance)."""
    import pandas as pd

    base = os.path.join(src, "y2005cc", "raw-data")
    df = pd.read_csv(os.path.join(base, "data.csv"))
    comp = pd.read_csv(os.path.join(base, "cov_components.csv"))
    _save(
        "cc",
        legend=np.array("Cosmic Chronometers"),
        z=df["z"].to_numpy(np.float64),
        H=df["H"].to_numpy(np.float64),
        sigma_H=df["sigma_H"].to_numpy(np.float64),
        comp_z=comp["z"].to_numpy(np.float64),
        comp_imf=comp["imf"].to_numpy(np.float64),
        comp_stlib=comp["stlib"].to_numpy(np.float64),
        comp_sps=comp["sps"].to_numpy(np.float64),
        comp_spsooo=comp["spsooo"].to_numpy(np.float64),
    )


def ingest_quasars(src):
    """Lusso+2020 standardised quasars (2420 objects)."""
    import pandas as pd

    base = os.path.join(src, "y2018quasars", "raw-data")
    df = pd.read_csv(os.path.join(base, "data.txt"), sep=r"\s+").sort_values(by="z")
    _save(
        "quasars",
        legend=np.array("Quasars (Lusso+2020)"),
        z=df["z"].to_numpy(np.float64),
        dm=df["DM"].to_numpy(np.float64),
        e_dm=df["e_DM"].to_numpy(np.float64),
    )


def ingest_fs8(src):
    import pandas as pd

    base = os.path.join(src, "y2018fs8", "raw")
    df = pd.read_csv(os.path.join(base, "fs8.csv"))
    cov = np.genfromtxt(os.path.join(base, "fs8_cov.dat"))
    _save(
        "fs8",
        legend=np.array("fsigma8 compilation"),
        z=df["z"].to_numpy(np.float64),
        fs8=df["fs8"].to_numpy(np.float64),
        fs8_err=df["fs8_err"].to_numpy(np.float64),
        omega_fid=df["omega_fid"].to_numpy(np.float64),
        cov=np.asarray(cov, dtype=np.float64),
    )


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", required=True, help="the raw data checkout")
    args = p.parse_args(argv)
    src = args.source
    ingest_bao(src, "y2025BAO", "desi_dr2", "DESI BAO DR2")
    ingest_bao(src, "y2020SDSSBAO", "sdss_dr16", "SDSS BAO DR16")
    ingest_pantheon_plus(src)
    ingest_des5y(src)
    ingest_union3(src)
    ingest_union21(src)
    ingest_pantheon18(src)
    ingest_cc(src)
    ingest_quasars(src)
    ingest_fs8(src)


if __name__ == "__main__":
    main()
