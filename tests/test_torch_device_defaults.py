"""Every public entry point of the port runs on the card unless the
caller asks for the CPU: called with no ``device`` where CUDA is absent,
each raises (``device.resolve``) instead of running on the CPU."""

import numpy as np
import pytest
import torch

from cosmax_torch.likelihoods.base import autograd_value_and_grad

BOUNDS = np.array([[-1.0, 1.0], [-2.0, 2.0]])


def _vg():
    return autograd_value_and_grad(lambda x: -0.5 * (x * x).sum(-1))


def _entry_points(tmp_path):
    from cosmax_torch.compat import EnsembleSampler as Facade
    from cosmax_torch.gp import ExactGP, fit_gp
    from cosmax_torch.models.scalar_field import reconstruct
    from cosmax_torch.samplers import checkpoints as ck
    from cosmax_torch.samplers.ensemble import ChainState, uniform_init
    from cosmax_torch.samplers.evidence import SteppingStone
    from cosmax_torch.samplers.hmc import BoxTransform, HMCSampler
    from cosmax_torch.samplers.optimize import laplace, minimize_chi2

    path = str(tmp_path / "c.npz")
    ck.save_state(path, ChainState(torch.zeros(4, 2), torch.zeros(4), 0, 1))
    return {
        "HMCSampler": lambda: HMCSampler(_vg(), BOUNDS, 4),
        "BoxTransform.from_bounds": lambda: BoxTransform.from_bounds(BOUNDS),
        "SteppingStone": lambda: SteppingStone(_vg(), BOUNDS),
        "minimize_chi2": lambda: minimize_chi2(lambda x: (x * x).sum(), np.zeros(2)),
        "laplace": lambda: laplace(lambda x: -(x * x).sum(), np.zeros(2)),
        "uniform_init": lambda: uniform_init(torch.Generator(), BOUNDS, 4),
        "load_state": lambda: ck.load_state(path),
        "load_hmc_state": lambda: ck.load_hmc_state(path),
        "load_hmc_warmup_state": lambda: ck.load_hmc_warmup_state(path),
        "compat.EnsembleSampler": lambda: Facade(4, 2, lambda x: -(x * x).sum()),
        "ExactGP": lambda: ExactGP(np.zeros(2), np.zeros(2), np.eye(2), (1.0, 2.0)),
        "fit_gp": lambda: fit_gp(np.array([0.1, 0.5]), np.array([70.0, 90.0]), np.eye(2),
                                 iters=1),
        "reconstruct": lambda: reconstruct(0.3, -0.9),
    }


NAMES = ["HMCSampler", "BoxTransform.from_bounds", "SteppingStone", "minimize_chi2", "laplace",
         "uniform_init", "load_state", "load_hmc_state", "load_hmc_warmup_state",
         "compat.EnsembleSampler", "ExactGP", "fit_gp", "reconstruct"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the default is valid")
@pytest.mark.parametrize("name", NAMES)
def test_default_device_is_the_card(tmp_path, name):
    call = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_cpu_on_request(tmp_path):
    from cosmax_torch.samplers import checkpoints as ck
    from cosmax_torch.samplers.ensemble import ChainState
    from cosmax_torch.samplers.optimize import laplace

    path = str(tmp_path / "c.npz")
    ck.save_state(path, ChainState(torch.zeros(4, 2), torch.zeros(4), 3, 1))
    assert ck.load_state(path, "cpu").walkers.device.type == "cpu"
    cov, _, _ = laplace(lambda x: -0.5 * (x * x).sum(), np.zeros(2), device="cpu")
    np.testing.assert_allclose(cov, np.eye(2), atol=1e-12)  # float64 on the CPU by default
