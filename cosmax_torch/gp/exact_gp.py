"""Exact Gaussian-process regression of H(z) from cosmic chronometers
(counterpart of ``cosmax/gp/exact_gp.py``), in plain torch.

The reference's gpytorch stack (cosmic_chronometers/gp_lib.py + cc_gp.py)
as an ``nn.Module``:

* RBF kernel with a learnable output scale (softplus of
  ``raw_outputscale``) and a lengthscale constrained to the interval
  (1.2 z_max, 3 z_max) by the sigmoid transform of gpytorch's Interval
  (cc_gp.py:27-29);
* constant mean ``mean_const``;
* fixed observation noise given as a full PSD covariance times a
  learnable scalar ``noise_scale`` (gp_lib.py:13-67), the GP counterpart
  of the CC error-rescaling nuisance f (the reference finds noise_scale
  ~ 0.699^2 ~ f^2);
* hyperparameters fitted by Adam (lr 0.01, 5000 iterations,
  cc_gp.py:46-70) on the exact marginal log-likelihood;
* predictive mean / covariance on a test grid, and the deceleration
  parameter q(z) = -1 + (1+z) H'(z)/H(z) by autograd through the
  predictive mean (cc_gp.py:88-94).

The methods take the hyperparameters as a ``GPParams`` (default: the
module's own parameters), so two GPs can be evaluated at the same point.
The softplus is ``logaddexp(x, 0)`` (``torch.nn.functional.softplus``
switches to the identity above its threshold). The Cholesky factor comes
from ``torch.linalg.cholesky_ex``: the fitting loop collects its ``info``
on the device and raises after the loop if any step's factorisation
failed (``torch.linalg.cholesky`` would synchronise with the host at
every step to check it). Runs on the card in float32 unless the caller
asks for the CPU, where float64 is allowed.
"""

from typing import NamedTuple

import numpy as np
import torch

from cosmax_torch.device import resolve


class GPParams(NamedTuple):
    raw_outputscale: torch.Tensor  # softplus-constrained, as gpytorch
    raw_lengthscale: torch.Tensor  # sigmoid interval (lo, hi)
    mean_const: torch.Tensor
    noise_scale: torch.Tensor  # unconstrained scalar multiplier


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _inv_softplus(y):
    return float(np.log(np.expm1(y)))


def _check_factorisation(info, what):
    if int(info) != 0:
        raise torch.linalg.LinAlgError(
            f"{what}: the GP's training covariance is not positive definite "
            f"(Cholesky info {int(info)})"
        )


class ExactGP(torch.nn.Module):
    """``ExactGP(x, y, noise_cov, lengthscale_interval)`` on standardised
    data; see ``fit_gp`` for the turnkey path. ``x``, ``y`` [N] and
    ``noise_cov`` [N, N] are buffers on ``device`` in ``dtype``; the four
    hyperparameters are the module's parameters."""

    def __init__(self, x, y, noise_cov, lengthscale_interval, device="cuda", dtype=None):
        super().__init__()
        device, dtype = resolve(device, dtype)

        def t(a):
            return torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)

        self.register_buffer("x", t(x))
        self.register_buffer("y", t(y))
        self.register_buffer("noise_cov", t(noise_cov))
        self.ls_lo, self.ls_hi = map(float, lengthscale_interval)
        self.n = int(self.x.shape[0])
        init = self.init_params()
        for name, value in init._asdict().items():
            setattr(self, name, torch.nn.Parameter(value))

    def init_params(self) -> GPParams:
        def t(v):
            return torch.tensor(v, device=self.x.device, dtype=self.x.dtype)

        return GPParams(
            raw_outputscale=t(_inv_softplus(1.0)),
            raw_lengthscale=t(0.0),  # interval midpoint
            mean_const=t(0.0),
            noise_scale=t(1.0),
        )

    def params(self) -> GPParams:
        """The module's own hyperparameters."""
        return GPParams(self.raw_outputscale, self.raw_lengthscale, self.mean_const,
                        self.noise_scale)

    def _p(self, p):
        return self.params() if p is None else p

    # -- constrained hyperparameters ----------------------------------
    def outputscale(self, p: GPParams = None):
        return _softplus(self._p(p).raw_outputscale)

    def lengthscale(self, p: GPParams = None):
        return self.ls_lo + (self.ls_hi - self.ls_lo) * torch.sigmoid(self._p(p).raw_lengthscale)

    # -- kernel -------------------------------------------------------
    def kernel(self, p: GPParams, xa, xb):
        d = (xa[:, None] - xb[None, :]) / self.lengthscale(p)
        return self.outputscale(p) * torch.exp(-0.5 * d * d)

    def train_cov(self, p: GPParams = None):
        p = self._p(p)
        return self.kernel(p, self.x, self.x) + self.noise_cov * p.noise_scale

    def _as_grid(self, x):
        return torch.atleast_1d(torch.as_tensor(x, device=self.x.device)).to(self.x.dtype)

    # -- marginal likelihood ------------------------------------------
    def _factor(self, p):
        """(Cholesky factor of the training covariance, its info, alpha =
        C^-1 (y - mean)); info != 0 marks a failed factorisation. alpha
        comes from two triangular solves (cuBLAS on the card):
        ``torch.cholesky_solve`` goes through MAGMA there, which waits for
        the host at every call, forward and backward."""
        chol, info = torch.linalg.cholesky_ex(self.train_cov(p))
        delta = (self.y - p.mean_const)[:, None]
        u = torch.linalg.solve_triangular(chol, delta, upper=False)
        return chol, info, torch.linalg.solve_triangular(chol.T, u, upper=True)[:, 0]

    def _mll(self, p):
        chol, info, alpha = self._factor(p)
        delta = self.y - p.mean_const
        logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
        return -0.5 * (delta @ alpha + logdet + self.n * np.log(2.0 * np.pi)), info

    def mll(self, p: GPParams = None):
        """Exact marginal log-likelihood (sum over data, with the
        constant), as gpytorch's ExactMarginalLogLikelihood * N."""
        value, info = self._mll(self._p(p))
        _check_factorisation(info, "mll")
        return value

    # -- prediction ---------------------------------------------------
    def predict_mean(self, p: GPParams, x_test):
        p = self._p(p)
        _, info, alpha = self._factor(p)
        _check_factorisation(info, "predict_mean")
        return p.mean_const + self.kernel(p, self._as_grid(x_test), self.x) @ alpha

    def predict(self, p: GPParams, x_test, test_noise=1e-4):
        """(mean, cov) of the posterior predictive with ``test_noise`` on
        the diagonal (the reference uses 1e-4, cc_gp.py:76)."""
        p = self._p(p)
        x_test = self._as_grid(x_test)
        chol, info, alpha = self._factor(p)
        _check_factorisation(info, "predict")
        k_star = self.kernel(p, x_test, self.x)
        mean = p.mean_const + k_star @ alpha
        v = torch.linalg.solve_triangular(chol, k_star.T, upper=False)
        eye = torch.eye(x_test.shape[0], device=x_test.device, dtype=x_test.dtype)
        cov = self.kernel(p, x_test, x_test) - v.T @ v + test_noise * eye
        return mean, cov

    # -- fantasy models -----------------------------------------------
    def condition_on(self, x_new, y_new, noise_new) -> "ExactGP":
        """Fantasy model: a new ``ExactGP`` conditioned on extra
        observations without refitting hyperparameters.

        The counterpart of gpytorch's ``ExactGP.get_fantasy_model`` +
        ``FixedNoiseGaussianLikelihood.get_fantasy_likelihood`` (reference
        cosmic_chronometers/gp_lib.py:155-179): the training set becomes
        the concatenation of the current data and ``(x_new, y_new)``, and
        the noise covariance is extended block-diagonally; ``noise_new``
        may be a 1-D vector of variances or a full PSD matrix. The new GP
        starts from this one's hyperparameter values, and ``noise_scale``
        multiplies the extended covariance as it does the original one.

        Inputs are in the GP's (standardised) units, the frame of
        ``self.x`` / ``self.y``.
        """
        x_new = self._as_grid(x_new)
        y_new = self._as_grid(y_new)
        noise_new = torch.as_tensor(noise_new, device=self.x.device).to(self.x.dtype)
        if noise_new.dim() == 1:
            noise_new = torch.diag(noise_new)
        k = x_new.shape[0]
        if y_new.shape[0] != k or tuple(noise_new.shape) != (k, k):
            raise ValueError(
                "condition_on: x_new, y_new and noise_new must describe the same number of "
                f"points; got {k} x, {y_new.shape[0]} y, noise {tuple(noise_new.shape)}"
            )
        gp = ExactGP(
            torch.cat([self.x, x_new]).cpu().double().numpy(),
            torch.cat([self.y, y_new]).cpu().double().numpy(),
            torch.block_diag(self.noise_cov, noise_new).cpu().double().numpy(),
            (self.ls_lo, self.ls_hi), device=self.x.device, dtype=self.x.dtype,
        )
        with torch.no_grad():
            for mine, theirs in zip(gp.params(), self.params()):
                mine.copy_(theirs)
        return gp


def fit_gp(
    z,
    y,
    noise_cov,
    lengthscale_interval=None,
    iters: int = 5000,
    lr: float = 0.01,
    standardize: bool = True,
    device="cuda",
    dtype=None,
):
    """Standardise, build and Adam-fit the GP (cc_gp.py:14-70); returns
    (gp, params, info), where info carries the standardisation, the loss
    history and the fitted hyperparameters. The loop runs on ``device``
    without a host round trip; a failed Cholesky at any step raises after
    it."""
    z = np.asarray(z, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    noise_cov = np.asarray(noise_cov, dtype=np.float64)
    if standardize:
        y_mean, y_std = float(np.mean(y)), float(np.std(y))
    else:
        y_mean, y_std = 0.0, 1.0
    y_s = (y - y_mean) / y_std
    cov_s = noise_cov / y_std**2
    if lengthscale_interval is None:
        lengthscale_interval = (1.2 * z.max(), 3.0 * z.max())

    gp = ExactGP(z, y_s, cov_s, lengthscale_interval, device=device, dtype=dtype)
    losses, first_failure = _adam(gp, iters, lr)
    if int(first_failure) >= 0:
        raise torch.linalg.LinAlgError(
            f"fit_gp: the training covariance's Cholesky failed at Adam step "
            f"{int(first_failure)} of {iters}"
        )
    params = GPParams(*(t.detach().clone() for t in gp.params()))
    info = dict(
        y_mean=y_mean,
        y_std=y_std,
        losses=losses.cpu().double().numpy(),
        outputscale=float(gp.outputscale(params)) * y_std**2,
        lengthscale=float(gp.lengthscale(params)),
        noise_scale=float(params.noise_scale),
    )
    return gp, params, info


def _adam(gp, iters, lr):
    """``iters`` Adam steps on -mll of ``gp``'s parameters, with no host
    round trip: (the loss before each step [iters], the first step whose
    Cholesky failed, or -1), both on the device. On the CPU each step runs
    eagerly. On the card a step is ~100 small launches, which the host
    cannot enqueue faster than ~5 ms a step: after three eager steps on a
    side stream (they set up Adam's state) one step is captured in a CUDA
    graph and replayed, Adam in its capturable form (its step counts on
    the device)."""
    on_card = gp.x.device.type == "cuda"
    # optax.adam(lr): the same update (its eps_root is 0)
    opt = torch.optim.Adam(gp.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=on_card)
    losses = torch.zeros(iters, device=gp.x.device, dtype=gp.x.dtype)
    first_failure = torch.full((), -1, device=gp.x.device, dtype=torch.long)
    step = torch.zeros(1, device=gp.x.device, dtype=torch.long)

    def adam_step():
        value, info = gp._mll(gp.params())
        loss = -value
        loss.backward()
        opt.step()
        losses.index_copy_(0, step, loss.detach().reshape(1))
        first_failure.copy_(torch.where((info != 0) & (first_failure < 0), step[0],
                                        first_failure))
        step.add_(1)

    if not on_card:
        for _ in range(iters):
            opt.zero_grad(set_to_none=True)
            adam_step()
        return losses, first_failure
    warm = min(3, iters)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warm):
            opt.zero_grad(set_to_none=True)
            adam_step()
    torch.cuda.current_stream().wait_stream(side)
    if iters > warm:
        graph = torch.cuda.CUDAGraph()
        opt.zero_grad(set_to_none=True)
        with torch.cuda.graph(graph):
            adam_step()
        for _ in range(iters - warm):
            graph.replay()
    return losses, first_failure


def reconstruct_hz(z, h, cov, n_grid: int = 100, **kwargs):
    """The cc_gp pipeline: fit, predict H(z) on a grid, and derive q(z) =
    -1 + (1+z) H'/H by autograd through the predictive mean. Each mean
    depends on its own z only, so one backward of their sum gives every
    H'(z). Returns a dict with the grid, H mean / std / covariance, q(z)
    (numpy) and the fitted hyperparameters (the reference prints
    lengthscale ~ 2.366 and noise_scale ~ 0.699^2, cc_gp.py:63-64)."""
    gp, params, info = fit_gp(z, h, cov, **kwargs)
    z_grid = torch.linspace(0.0, float(np.max(z)), n_grid, device=gp.x.device, dtype=gp.x.dtype)
    with torch.no_grad():
        mean_s, cov_s = gp.predict(params, z_grid)
    zg = z_grid.clone().requires_grad_(True)
    with torch.enable_grad():
        h_vals = gp.predict_mean(params, zg) * info["y_std"] + info["y_mean"]
        (dh_dz,) = torch.autograd.grad(h_vals.sum(), zg)
    q = -1.0 + (1.0 + z_grid) * dh_dz / h_vals.detach()

    def host(t):
        return t.detach().cpu().double().numpy()

    h_std = np.sqrt(np.clip(np.diag(host(cov_s)), 0.0, None)) * info["y_std"]
    return dict(
        z_grid=host(z_grid),
        h_mean=host(mean_s) * info["y_std"] + info["y_mean"],
        h_std=h_std,
        h_cov=host(cov_s) * info["y_std"] ** 2,
        q=host(q),
        info=info,
        params=params,
        gp=gp,
    )
