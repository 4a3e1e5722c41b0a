"""The port's quintessence reconstruction (``cosmax_torch.models.
scalar_field``, ``python -m cosmax_torch.field``) against the JAX
package's with x64 on (1e-9 relative), the cases of
tests/test_scalar_field.py, the CLI's figures and refusal
(tests/test_plots.py:57-86), and the torch ``interp`` against
``np.interp``."""

import json

import jax
import numpy as np
import pytest
import torch

from cosmax.models import scalar_field as jax_field
from cosmax_torch.models.scalar_field import reconstruct, rho_de, w_de
from cosmax_torch.ops.quadrature import interp

F64 = torch.float64


@pytest.mark.parametrize("om,w0", [(0.307, -0.833), (0.3, -1.0), (0.35, -0.6)])
def test_reconstruct_matches_jax_x64(om, w0):
    with jax.enable_x64(True):
        want = {k: np.asarray(v) for k, v in jax_field.reconstruct(om, w0).items()}
    got = reconstruct(om, w0, device="cpu", dtype=F64)
    assert set(got) == set(want)
    for k in want:
        scale = max(np.max(np.abs(want[k])), 1e-300)
        assert np.max(np.abs(got[k] - want[k])) <= 1e-9 * scale, k


def test_w_limits():
    assert w_de(np.asarray(1e-6), -0.8) == pytest.approx(-1.0, abs=1e-5)
    assert float(w_de(np.asarray(1e3), -0.8)) == pytest.approx(1 + 2 * -0.8, abs=1e-5)


def test_rho_normalised_today():
    assert float(rho_de(np.asarray(1.0), -0.833)) == pytest.approx(
        (2.0 / 2.0) ** (2 * (1 - 0.833)), rel=1e-12)


def test_reconstruction_monotonic_field():
    out = reconstruct(om=0.307, w0=-0.833, device="cpu")
    assert np.all(np.diff(out["phi"]) >= 0)
    assert np.all(np.isfinite(out["v_of_phi"]))
    assert out["v_of_a"][0] > out["v_of_a"][-1]


def test_lcdm_limit_frozen_field():
    out = reconstruct(om=0.3, w0=-1.0, device="cpu", dtype=F64)
    np.testing.assert_allclose(out["phi"], 0.0, atol=1e-12)
    np.testing.assert_allclose(out["v_of_a"], 1.0, rtol=1e-12)


def test_interp_matches_numpy():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(-1, 2, 50))
    xp[10] = xp[11]  # a zero-width interval
    fp = np.sin(3 * xp)
    x = np.concatenate([rng.uniform(-1.5, 2.5, 200), xp, [xp[0], xp[-1]]])
    got = interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    want = np.interp(x, xp, fp)
    ok = ~np.isin(x, xp[10])  # numpy and jnp differ on a duplicated node
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-13, atol=1e-15)
    import jax.numpy as jnp

    with jax.enable_x64(True):
        np.testing.assert_allclose(got, np.asarray(jnp.interp(x, xp, fp)), rtol=1e-13,
                                   atol=1e-15)


def test_field_cli_writes_five_figures(tmp_path):
    from cosmax_torch.field import main

    assert main(["--out", str(tmp_path), "--device", "cpu"]) == 0
    for name in ("field_phi_a.png", "field_v_phi.png", "field_v_a.png",
                 "field_kinetic_t.png", "field_phi_t.png"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_field_cli_reads_summary(tmp_path):
    from cosmax_torch.field import main

    summ = dict(params={"Om": {"median": 0.31}, "w0": {"median": -0.85}})
    (tmp_path / "summary.json").write_text(json.dumps(summ))
    assert main(["--summary", str(tmp_path), "--out", str(tmp_path / "figs"),
                 "--device", "cpu"]) == 0
    assert (tmp_path / "figs" / "field_phi_a.png").stat().st_size > 0


def test_field_cli_rejects_phantom_w0(tmp_path):
    from cosmax_torch.field import main

    with pytest.raises(SystemExit, match="phantom"):
        main(["--w0", "-1.2", "--out", str(tmp_path), "--device", "cpu"])
