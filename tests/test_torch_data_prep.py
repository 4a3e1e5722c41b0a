"""The port's data preparation (``cosmax_torch.data.ingest`` / ``fetch``)
against the JAX package's on offline fakes: the release parsers, the
store patches, the download pipeline with ``urlopen`` stubbed (nothing
reaches the network), and ``ingest_bao`` on a synthetic CSV, each giving
the same arrays from both packages. The full-store reproduction runs
only where a raw data checkout is named by ``COSMAX_RAW_SOURCE``."""

import gzip
import hashlib
import os

import numpy as np
import pytest

import cosmax.data.fetch as jax_fetch
import cosmax.data.ingest as jax_ingest
import cosmax_torch.data.fetch as fetch
import cosmax_torch.data.ingest as ingest

RAW = os.environ.get("COSMAX_RAW_SOURCE", "")


def _spd(n, seed):
    a = np.random.default_rng(seed).normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def _nfirst(cov, gz=False):
    raw = (f"{cov.shape[0]}\n" + "\n".join(f"{v:.17g}" for v in cov.ravel())).encode()
    return gzip.compress(raw) if gz else raw


def _same_npz(a, b):
    za, zb = dict(np.load(a)), dict(np.load(b))
    assert set(za) == set(zb)
    for k in za:
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_parsers_match_jax():
    cov = _spd(5, 0)
    for raw, fmt in ((_nfirst(cov), "nfirst"), (_nfirst(cov, gz=True), "nfirst"),
                     ("\n".join("\t".join(f"{v:.17g}" for v in r) for r in cov).encode(),
                      "dense")):
        np.testing.assert_array_equal(fetch.parse_cov(raw, fmt), jax_fetch.parse_cov(raw, fmt))
    for bad, fmt, msg in ((b"3\n1.0 2.0", "nfirst", "expected"), (b"1 2 3", "dense", "square")):
        with pytest.raises(ValueError, match=msg):
            fetch.parse_cov(bad, fmt)
    for raw, ds in ((b"CID,zHD,MU\na,0.3,35\nb,0.1,33\n", "des5y"),
                    (b"# Union2.1\nSN1\t0.5\t42.0\t0.2\nSN2\t0.2\t40.0\t0.1\n", "union21"),
                    (b"#name zcmb zhel\na 0.1 0.1\nb 0.4 0.4\n", "pantheon18")):
        np.testing.assert_array_equal(fetch.parse_redshifts(raw, ds),
                                      jax_fetch.parse_redshifts(raw, ds))


def _des5y_bundle(path, raw_z):
    order = np.argsort(raw_z)
    np.savez(path, z_hd=raw_z[order], mu_err=np.array([0.2, 0.1, 0.15])[order], mu=np.zeros(3),
             z_hel=raw_z[order], effective_sample_size=np.int64(3), legend=np.array("synthetic"))


def _pantheon18_bundle(path, raw_z):
    order = np.argsort(raw_z)
    np.savez(path, mb=np.zeros(raw_z.size), dmb=np.full(raw_z.size, 0.1), z_cmb=raw_z[order],
             z_hel=raw_z[order], legend=np.array("synthetic"))


@pytest.mark.parametrize("dataset,raw_z,bundle", [
    ("des5y", np.array([0.4, 0.1, 0.3]), _des5y_bundle),
    ("pantheon18", np.array([0.5, 0.1, 0.9, 0.3]), _pantheon18_bundle),
])
def test_patch_store_matches_jax(tmp_path, dataset, raw_z, bundle):
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        bundle(tmp_path / d / f"{dataset}.npz", raw_z)
    cov = _spd(raw_z.size, 2)
    jax_fetch.patch_store(dataset, cov, raw_z=raw_z, store=str(tmp_path / "jax"))
    fetch.patch_store(dataset, cov, raw_z=raw_z, store=str(tmp_path / "port"))
    _same_npz(tmp_path / "jax" / f"{dataset}.npz", tmp_path / "port" / f"{dataset}.npz")
    with pytest.raises(ValueError, match="do not match"):
        fetch.patch_store(dataset, cov, raw_z=raw_z + 0.01, store=str(tmp_path / "port"))
    with pytest.raises(ValueError, match="companion"):
        fetch.patch_store(dataset, cov, store=str(tmp_path / "port"))
    bad = cov.copy()
    bad[0, 1] += 10.0
    with pytest.raises(ValueError, match="asymmetric"):
        fetch.patch_store(dataset, bad, raw_z=raw_z, store=str(tmp_path / "port"))


class _FakeResponse:
    def __init__(self, payload):
        self._payload = payload

    def read(self):
        return self._payload

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _stub_urlopen(monkeypatch, payloads):
    """Every download is one of ``payloads``; any other URL fails."""
    import urllib.request

    def fake(url, timeout=None):
        if url not in payloads:
            raise AssertionError(f"unexpected URL {url}")
        return _FakeResponse(payloads[url])

    monkeypatch.setattr(urllib.request, "urlopen", fake)


def test_fetch_pipeline_matches_jax(tmp_path, monkeypatch):
    """des5y end to end minus the socket in both packages: gz nfirst
    payload, csv companion, z-sort, provenance; the same bundle."""
    raw_z = np.array([0.4, 0.1, 0.3])
    cov = _spd(3, 7)
    payload = _nfirst(cov, gz=True)
    assert fetch._URLS == jax_fetch._URLS
    url, _, companion = fetch._URLS["des5y"]
    _stub_urlopen(monkeypatch, {url: payload, companion: b"CID,zHD,MU\na,0.4,35\nb,0.1,33\n"
                                                        b"c,0.3,34\n"})
    for mod, d in ((jax_fetch, "jax"), (fetch, "port")):
        (tmp_path / d).mkdir()
        _des5y_bundle(tmp_path / d / "des5y.npz", raw_z)
        monkeypatch.setitem(mod._EXPECTED_N, "des5y", 3)
        path = mod.fetch("des5y", store=str(tmp_path / d))
    _same_npz(tmp_path / "jax" / "des5y.npz", path)
    b = np.load(path)
    assert str(b["cov_fetch_sha256"]) == hashlib.sha256(payload).hexdigest()


def test_fetch_rejects_sha_and_size_drift(tmp_path, monkeypatch):
    raw_z = np.linspace(0.1, 1.0, 4)
    _pantheon18_bundle(tmp_path / "pantheon18.npz", raw_z)
    cov = _spd(4, 8)
    url, _, companion = fetch._URLS["pantheon18"]
    lcparam = b"#name zcmb zhel dz mb dmb\n" + b"".join(
        f"sn{i} {z:.17g} {z:.17g} 0 20 0.1\n".encode() for i, z in enumerate(raw_z))
    _stub_urlopen(monkeypatch, {url: _nfirst(cov), companion: lcparam})
    with pytest.raises(ValueError, match="format drift"):
        fetch.fetch("pantheon18", store=str(tmp_path))
    monkeypatch.setitem(fetch._EXPECTED_N, "pantheon18", 4)
    monkeypatch.setitem(fetch._SHA256, "pantheon18", "0" * 64)
    with pytest.raises(ValueError, match="sha256"):
        fetch.fetch("pantheon18", store=str(tmp_path))
    monkeypatch.setitem(fetch._SHA256, "pantheon18", hashlib.sha256(_nfirst(cov)).hexdigest())
    np.testing.assert_allclose(np.load(fetch.fetch("pantheon18", store=str(tmp_path)))["cov_sys"],
                               cov, atol=1e-12)


def test_postcheck_through_the_port(monkeypatch):
    monkeypatch.setitem(fetch._POSTCHECKS, "des5y",
                        ("bao.desi", {"h": 0.690, "Om": 0.298}, 10.27))
    assert abs(fetch.postcheck("des5y", device="cpu")) < 0.1
    monkeypatch.setitem(fetch._POSTCHECKS, "des5y",
                        ("bao.desi", {"h": 0.690, "Om": 0.298}, 500.0))
    with pytest.raises(ValueError, match="convention"):
        fetch.postcheck("des5y", device="cpu")


def test_patched_bundle_loads_with_full_covariance(tmp_path, monkeypatch):
    import cosmax_torch.data.loaders as loaders

    src = dict(np.load(os.path.join(loaders._STORE, "pantheon18.npz")))
    src.pop("cov_sys", None)
    np.savez(tmp_path / "pantheon18.npz", **src)
    monkeypatch.setattr(loaders, "_STORE", str(tmp_path))
    loaders._bundle.cache_clear()
    try:
        assert loaders.load_sn("pantheon18").synthetic_cov
        sys_cov = _spd(len(src["mb"]), 5) * 1e-4
        fetch.patch_store("pantheon18", sys_cov, raw_z=src["z_cmb"], store=str(tmp_path))
        after = loaders.load_sn("pantheon18")
        assert not after.synthetic_cov
        np.testing.assert_allclose(after.cov, 0.5 * (sys_cov + sys_cov.T)
                                   + np.diag(src["dmb"] ** 2))
    finally:
        loaders._bundle.cache_clear()


def test_ingest_bao_matches_jax(tmp_path, monkeypatch):
    base = tmp_path / "src" / "y2025BAO" / "raw-data"
    base.mkdir(parents=True)
    (base / "data.csv").write_text(
        "z,value,quantity\n0.295,7.94,DV_over_rs\n0.51,13.59,DM_over_rs\n0.51,21.86,DH_over_rs\n")
    np.savetxt(base / "covariance.txt", np.diag([0.1, 0.2, 0.3]) + 0.01)
    for mod, d in ((jax_ingest, "jax"), (ingest, "port")):
        (tmp_path / d).mkdir()
        monkeypatch.setattr(mod, "STORE", str(tmp_path / d))
        mod.ingest_bao(str(tmp_path / "src"), "y2025BAO", "desi_test", "DESI test")
    _same_npz(tmp_path / "jax" / "desi_test.npz", tmp_path / "port" / "desi_test.npz")


def test_ingest_store_path_is_the_loaders():
    import cosmax_torch.data.loaders as loaders

    assert ingest.STORE == loaders._STORE and fetch.STORE == loaders._STORE


@pytest.mark.skipif(not RAW or not os.path.isdir(os.path.join(RAW, "y2025BAO")),
                    reason="no raw data checkout named by COSMAX_RAW_SOURCE")
def test_ingest_reproduces_committed_store(tmp_path, monkeypatch):
    import cosmax_torch.data.loaders as loaders

    monkeypatch.setattr(ingest, "STORE", str(tmp_path))
    ingest.main(["--source", RAW])
    for name in os.listdir(tmp_path):
        _same_npz(tmp_path / name, os.path.join(loaders._STORE, name))
