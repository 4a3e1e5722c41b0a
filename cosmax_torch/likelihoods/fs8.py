"""Growth-rate fsigma8 likelihood with the Alcock-Paczynski correction
(counterpart of ``cosmax/likelihoods/fs8.py``).

Theory fsigma8(z) from the growth ODE (``models.growth``). Each data
point carries the fiducial Omega_m of its survey; the AP factor is

    q_i = E(z_i) D_M(z_i) / (E_fid(z_i) D_M_fid(z_i))

(reference fs8/fs8.py:31-32,75). The fiducial denominators do not
depend on the parameters and are computed with scipy at build time; the
model's D_M is Gauss-Legendre. The error-rescaling nuisance ``f_err``
enters as chi^2 / f_err^2 with normalisation -N ln f_err
(fs8/fs8.py:72-85).

* Parity path: the ODE per walker and the whitened residual (the CUDA
  chi^2 kernel on the card, N = 66).
* Fast path: the residual Linv(obs q_AP(theta)) - sigma8 Linv
  fsigma8(theta)/sigma8 is two geometry-only curves, registered as one
  group in the preset's bundle (``models.linear_chi2.make_amp_pair_chi2``);
  the growth ODE, the AP integrals and the whitening are folded into
  the f64 build tables. The build evaluates both curves over the grid's
  nodes in chunks under ``BUILD_TEMP_BYTES`` (each node's row is its
  own, so chunks give the same rows to rounding): the split w0wacdm
  grid's 64,000 nodes a half would otherwise take ~4,000 x 64,000 f64
  coefficient tables of the ODE, 2 GB each.
"""

import numpy as np
import scipy.integrate
import torch

from cosmax_torch.data.loaders import CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.likelihoods.fastmode import fast_mode
from cosmax_torch.models.background import e_of_z, expand_params
from cosmax_torch.models.distances import comoving_integral_gl
from cosmax_torch.models.growth import (
    SUBSTEPS,
    fsigma8,
    growth_curve,
    growth_elems_per_walker,
)
from cosmax_torch.ops.linalg import chi2_from_whitener

GL_ORDER = 64  # Gauss-Legendre nodes of the model's D_M
F_ERR = "f_err"  # the error-rescaling parameter
# Bytes of the largest temporary of a build curve over a chunk of nodes
BUILD_TEMP_BYTES = 256 << 20


def _over_node_chunks(curve, elems_per_node):
    """``curve(flat, to_params)`` evaluated over chunks of the nodes
    ``flat`` [M, P], each chunk's largest temporary (``elems_per_node``
    f64 values a node) under ``BUILD_TEMP_BYTES``."""
    def run(flat, to_params):
        chunk = max(1, BUILD_TEMP_BYTES // (8 * elems_per_node))
        if len(flat) <= chunk:
            return curve(flat, to_params)
        return np.concatenate([curve(flat[s:s + chunk], to_params)
                               for s in range(0, len(flat), chunk)])

    return run


def _fiducial_denominator(z, om_fid):
    """E_fid(z) * DM_fid(z) per point for flat LCDM fiducials, in the
    reference's dimensionless convention DM = int dz'/E (fs8/fs8.py:26-32)."""
    out = np.empty(z.size, dtype=np.float64)
    for i, (zi, omi) in enumerate(zip(z, om_fid)):
        def e(zp, omi=omi):
            return np.sqrt(omi * (1 + zp) ** 3 + (1 - omi))

        integral = scipy.integrate.quad(lambda zp: 1.0 / e(zp), 0.0, zi)[0]
        out[i] = e(zi) * integral
    return out


def build_fs8_term(
    dataset: CovDataset,
    model: str,
    *,
    device,
    dtype=torch.float32,
) -> Term:
    z = np.asarray(dataset.z, dtype=np.float64)
    fs8_obs = np.asarray(dataset.values, dtype=np.float64)
    linv = np.asarray(dataset.linv, np.float64)
    n = dataset.n
    fid_denom = _fiducial_denominator(z, np.asarray(dataset.omega_fid))
    meta = dict(n=n, legend=dataset.legend)

    if fast_mode():
        from cosmax_torch.models.linear_chi2 import _hash_arrays, make_amp_pair_chi2

        obs_over_fid = fs8_obs / fid_denom
        zt = torch.as_tensor(z)

        def curve_u(flat, to_params):
            p = to_params(torch.as_tensor(flat, dtype=torch.float64))
            e = e_of_z(zt, expand_params(p, 1), model)
            dm = comoving_integral_gl(zt, p, model, order=GL_ORDER)
            return (obs_over_fid * (e * dm).numpy()) @ linv.T

        def curve_v(flat, to_params):
            p = to_params(torch.as_tensor(flat, dtype=torch.float64))
            return growth_curve(z, p, model).numpy() @ linv.T

        raw_chi2 = make_amp_pair_chi2(
            model, _over_node_chunks(curve_u, z.size * GL_ORDER),
            _over_node_chunks(curve_v, growth_elems_per_walker()), "fs8",
            (_hash_arrays(z, linv, obs_over_fid), GL_ORDER, SUBSTEPS),
            "sigma8", device, dtype,
        )
        meta.update(amp_pair=raw_chi2)
        elems = 1
    else:
        c = constants_from_numpy(
            dict(z=z, fs8_obs=fs8_obs, fid_denom=fid_denom, linv=linv), device, dtype
        )

        def residual(p):
            theory = fsigma8(z, p, model)
            e_model = e_of_z(c["z"], expand_params(p, 1), model)
            q = e_model * comoving_integral_gl(c["z"], p, model, order=GL_ORDER) / c["fid_denom"]
            return c["fs8_obs"] * q - theory

        def raw_chi2(p):
            return chi2_from_whitener(c["linv"], residual(p))

        meta.update(constants=c)
        elems = max(growth_elems_per_walker(), z.size * GL_ORDER)

    def chi2(p):
        return raw_chi2(p) / p[F_ERR] ** 2

    def log_norm(p):
        return -n * torch.log(p[F_ERR])

    # chi2 * f^power and log_norm = const + coef * ln f, for the packer
    meta.update(rescale=dict(param=F_ERR, power=-2.0, ln_const=0.0, ln_coef=-float(n)))
    return Term(name="fs8", chi2=chi2, log_norm=log_norm, elems_per_walker=elems, meta=meta)
