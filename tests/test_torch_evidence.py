"""cosmax_torch.samplers.evidence: the stepping-stone cases of
tests/test_evidence.py as cases of the port, at the JAX tests'
tolerances: the beta schedule (equal to the JAX one), an analytic
Gaussian ln Z within 0.05 with its per-rung telescope, replicated
ladders whose scatter covers the truth, the per-rung split R-hat, and the
budget-doubling loop's flag when it has nothing to compare against."""

import jax
import numpy as np
import pytest
import torch

from cosmax.samplers.evidence import SteppingStone as JaxSteppingStone
from cosmax_torch.likelihoods.base import autograd_value_and_grad
from cosmax_torch.samplers.evidence import SteppingStone, stepping_stone_log_evidence

MEAN = np.array([0.2, -0.3])
SIG = np.array([0.3, 0.5])
BOUNDS = np.array([[-4.0, 4.0], [-4.0, 4.0]])
# edges > 7 sigma out: the truncated integral is the full one
LN_Z_TRUE = float(np.sum(np.log(np.sqrt(2 * np.pi) * SIG))
                  - np.sum(np.log(BOUNDS[:, 1] - BOUNDS[:, 0])))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The samplers run thousands of small tensor ops: on one intra-op
    thread each; beside other test processes a thread pool per op spins
    (a 10 s case took 450 s under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gauss_vg():
    mean, sig = torch.tensor(MEAN, dtype=torch.float32), torch.tensor(SIG, dtype=torch.float32)
    return autograd_value_and_grad(lambda x: -0.5 * (((x - mean) / sig) ** 2).sum(-1))


def test_beta_schedule_matches_jax():
    ss = SteppingStone(_gauss_vg(), np.array([[0.0, 1.0]]), n_rungs=16, device="cpu")
    b = ss.betas.numpy()
    with jax.enable_x64(True):
        want = np.asarray(JaxSteppingStone(lambda x: 0.0, np.array([[0.0, 1.0]]), n_rungs=16).betas)
    np.testing.assert_allclose(b, want, rtol=1e-6)
    assert b[0] == 0.0 and b[-1] == 1.0 and np.all(np.diff(b) > 0) and b[8] < 0.5


def test_gaussian_evidence_analytic():
    res = stepping_stone_log_evidence(_gauss_vg(), BOUNDS, seed=0, n_rungs=24, n_chains=64,
                                      n_warmup=300, n_samples=300, device="cpu")
    assert res.log_evidence == pytest.approx(LN_Z_TRUE, abs=0.05)
    assert res.error < 0.05
    assert 0.5 < res.acceptance < 0.95
    assert len(res.per_rung) == 24
    assert res.per_rung.sum() == pytest.approx(res.log_evidence, abs=1e-9)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replicated_error_covers_analytic_truth(seed):
    res = stepping_stone_log_evidence(_gauss_vg(), BOUNDS, seed=seed, n_rungs=16, n_chains=32,
                                      n_warmup=200, n_samples=200, n_replicates=4, device="cpu")
    assert res.per_replicate.shape == (4,)
    assert len(set(np.round(res.per_replicate, 12))) == 4  # independent ladders
    assert res.error > 0.0
    assert abs(res.log_evidence - LN_Z_TRUE) <= 4.0 * res.error
    assert res.per_rung.sum() == pytest.approx(res.log_evidence, abs=1e-9)


def test_rung_rhat_diagnostic():
    res = stepping_stone_log_evidence(_gauss_vg(), BOUNDS, seed=0, n_rungs=16, n_chains=32,
                                      n_warmup=200, n_samples=200, n_replicates=2, device="cpu")
    assert res.rung_rhat.shape == (16,)
    assert np.all(np.isfinite(res.rung_rhat))
    assert float(np.max(res.rung_rhat)) < 1.2
    assert res.converged is None


def test_until_stable_exhausted_flag():
    vg = autograd_value_and_grad(lambda x: -0.5 * ((x / 0.3) ** 2).sum(-1))
    res = stepping_stone_log_evidence(vg, BOUNDS, seed=0, n_rungs=8, n_chains=16, n_warmup=50,
                                      n_samples=50, until_stable=1e-6, max_doublings=0, device="cpu")
    assert res.converged is False
    assert len(res.history) == 1
