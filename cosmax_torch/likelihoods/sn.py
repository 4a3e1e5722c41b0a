"""Type Ia supernova likelihood (counterpart of ``cosmax/likelihoods/sn.py``).

* ``dense`` (parity path): one cumulative-trapezoid integral of 1/E on a
  fixed grid shared by all SNe, interpolated at the data redshifts, then
  the whitened residual against the full N x N factor (the CUDA chi^2
  kernel on the card). The grid and the data redshifts are static, so
  the interpolation indices and lerp weights are built once in f64 numpy
  and the runtime interpolation is two gathers and an FMA.
* ``emulated`` (fast path, and what ``dense`` becomes in fast mode): the
  residual is linear in the magnitude offset and in a sampled H0 (a
  uniform -5 log10 h shift), and depends on the dark-energy parameters
  only through the geometry deviation 5 log10(I(z_k; theta) / I_ref) on
  a log-z Chebyshev basis. ``models.linear_chi2`` tabulates its
  whitened-metric coefficient curve at build time, so chi^2 is a
  rank-space contraction plus O(R) flops per walker.
* ``compressed`` is not ported (ROADMAP.md queue 1, "Do not port").
"""

import numpy as np
import torch

from cosmax_torch.constants import C_KM_S
from cosmax_torch.data.loaders import CovDataset
from cosmax_torch.interop import constants_from_numpy
from cosmax_torch.likelihoods.base import Term
from cosmax_torch.likelihoods.fastmode import fast_mode
from cosmax_torch.models.background import e_of_z, expand_params
from cosmax_torch.models.emu_core import bary_weights, cheb_nodes
from cosmax_torch.ops.linalg import chi2_from_whitener
from cosmax_torch.ops.quadrature import cumtrapz, interp_apply, interp_weights


def _barycentric_matrix(nodes, x):
    """B[len(x), len(nodes)] with (B @ f(nodes)) = the Chebyshev
    interpolant of f evaluated at x (barycentric form, f64 numpy)."""
    diff = x[:, None] - nodes[None, :]
    exact = diff == 0.0
    diff = np.where(exact, 1.0, diff)
    num = bary_weights(len(nodes))[None, :] / diff
    b = num / num.sum(axis=1, keepdims=True)
    return np.where(exact.any(axis=1, keepdims=True), exact.astype(np.float64), b)


def build_sn_term(
    dataset: CovDataset,
    model: str,
    mag_param: str = "M",
    h0="H0",
    *,
    device,
    dtype=torch.float32,
    use_z_hel: bool = True,
    grid_num: int = 1000,
    cepheids: bool = False,
    name: str = "sn",
    method: str = "dense",
    cheb_order: int = 32,
) -> Term:
    """h0: a float fixes H0; the name of a sampled parameter reads it
    from the dict; None gives the H0-free form where ``mag_param``
    absorbs 5 log10(c/H0) + 25. ``cepheids`` takes the calibrator rows
    of ``dataset.ceph_dist`` (!= -9) as constants plus the magnitude.
    ``device`` is required, as for the other term builders."""
    if h0 is not None and not isinstance(h0, str):
        h0 = float(h0)
    if method == "dense" and fast_mode():
        method = "emulated"
    if method == "emulated":
        return _build_emulated_sn(
            dataset, model, mag_param, h0, device, dtype, use_z_hel, cheb_order, name, cepheids,
        )
    if method == "compressed":
        raise NotImplementedError(
            "SN method 'compressed' is not ported (ROADMAP.md queue 1, 'Do not port')"
        )
    if method != "dense":
        raise ValueError(f"unknown SN method {method!r}")
    z_cmb = np.asarray(dataset.z_cmb, dtype=np.float64)
    mags = np.asarray(dataset.values, dtype=np.float64)
    one_plus_z_hel = 1.0 + np.asarray(
        dataset.z_hel if use_z_hel else dataset.z_cmb, dtype=np.float64
    )
    # the grid ends exactly at max(z_cmb): that point lerps the last
    # interval with weight 1, as jnp.interp does
    z_grid = np.linspace(0.0, z_cmb.max(), num=grid_num)
    idx, t = interp_weights(z_cmb, z_grid)
    arrays = dict(
        linv=dataset.linv,
        values=mags,
        one_plus_z_hel=one_plus_z_hel,
        z_grid=z_grid,
        interp_idx=idx,
        interp_t=t,
    )
    if cepheids:
        ceph_dist = np.asarray(dataset.ceph_dist, dtype=np.float64)
        arrays.update(ceph_dist=ceph_dist, ceph_mask=(ceph_dist != -9).astype(np.float64))
    c = constants_from_numpy(arrays, device, dtype)

    def theory_mag(p):
        inv_e = 1.0 / e_of_z(c["z_grid"], expand_params(p, 1), model)
        integral = interp_apply(cumtrapz(inv_e, c["z_grid"]), c["interp_idx"], c["interp_t"])
        if h0 is None:
            mu = 25.0 + 5.0 * torch.log10(c["one_plus_z_hel"] * C_KM_S * integral)
        else:
            h0_val = p[h0][:, None] if isinstance(h0, str) else h0
            mu = 25.0 + 5.0 * torch.log10(
                c["one_plus_z_hel"] * (C_KM_S / h0_val) * integral
            )
        if cepheids:
            mu = torch.where(c["ceph_mask"] != 0, c["ceph_dist"], mu)
        return mu + p[mag_param][:, None]

    def chi2(p):
        return chi2_from_whitener(c["linv"], c["values"] - theory_mag(p))

    return Term(
        name=name,
        chi2=chi2,
        elems_per_walker=max(grid_num, z_cmb.size),
        meta=dict(
            _sn_meta(dataset, "dense"),
            theory_mag=theory_mag,
            constants=c,
        ),
    )


def _sn_meta(dataset, method):
    return dict(
        n=dataset.n,
        legend=dataset.legend,
        values=np.asarray(dataset.values, dtype=np.float64),
        method=method,
        plot_kind="sn",
        z=np.asarray(dataset.z_cmb, dtype=np.float64),
        errors=np.sqrt(np.diag(dataset.cov)),
    )


def _sn_geometry(dataset, mag_param, h0, use_z_hel, cheb_order, cepheids):
    """Build-time f64 geometry of the emulated path: the log-z Chebyshev
    basis, the whitened basis projection, the reference curve and the
    whitened residual at it."""
    import scipy.integrate

    z_cmb = np.asarray(dataset.z_cmb, dtype=np.float64)
    mags = np.asarray(dataset.values, dtype=np.float64)
    one_plus_z_hel = 1.0 + np.asarray(
        dataset.z_hel if use_z_hel else dataset.z_cmb, dtype=np.float64
    )
    linv = dataset.linv

    if cepheids:
        # calibrator rows are parameter-independent constants (mu_i =
        # CEPH_DIST_i + M): folded into the constant vector, with zeroed
        # basis rows, so only the magnitude column acts on them
        ceph_dist = np.asarray(dataset.ceph_dist, dtype=np.float64)
        cal_mask = ceph_dist != -9
    else:
        cal_mask = np.zeros(z_cmb.size, dtype=bool)

    hubble_flow = ~cal_mask
    u_data = np.where(hubble_flow, np.log(z_cmb), 0.0)
    nodes_u = cheb_nodes(cheb_order, u_data[hubble_flow].min(), u_data[hubble_flow].max())
    z_nodes = np.exp(nodes_u)
    b_mat = _barycentric_matrix(nodes_u, u_data)  # [N, K]
    b_mat[cal_mask] = 0.0
    b_tilde = np.concatenate([b_mat, np.ones((z_cmb.size, 1))], axis=1)
    p_mat = linv @ b_tilde  # [N, K+1]

    const = 25.0 + 5.0 * np.log10(one_plus_z_hel)
    if cepheids:
        const = np.where(cal_mask, ceph_dist, const)
    d_prime = mags - const

    # reference curve: flat LCDM Om = 0.3 at the fixed or typical H0
    h0_ref = h0 if isinstance(h0, float) else 70.0
    e_ref = lambda zz: np.sqrt(0.3 * (1.0 + zz) ** 3 + 0.7)
    i_ref = np.array(
        [scipy.integrate.quad(lambda zz: 1.0 / e_ref(zz), 0.0, zk)[0] for zk in z_nodes]
    )
    if h0 is None:
        g_ref = 5.0 * np.log10(C_KM_S * i_ref)
        offset_ref = -9.2  # typical H0-free offset
    else:
        g_ref = 5.0 * np.log10((C_KM_S / h0_ref) * i_ref)
        offset_ref = -19.35 if mag_param == "M" else 0.0
    c_ref = np.concatenate([g_ref, [offset_ref]])

    u_ref = linv @ d_prime - p_mat @ c_ref  # whitened residual at ref
    return dict(
        z_nodes=z_nodes, b_tilde=b_tilde, p_mat=p_mat, const=const, h0_ref=h0_ref,
        i_ref=i_ref, offset_ref=offset_ref, u_ref=u_ref,
    )


def _build_emulated_sn(
    dataset, model, mag_param, h0, device, dtype, use_z_hel, cheb_order, name, cepheids,
):
    """Parameter-grid rank-space SN chi^2. The whitened residual is

        r(p) = u_ref - P_g (g(theta, h) - g_ref) - (mag - offset_ref) w_M

    with P_g = Linv B the whitened log-z Chebyshev basis and
    g(theta, h) - g_ref = ghat(theta) - 5 log10(h/h_ref) 1_K. With the
    thin QR P_g = Q R the emulated curve is c(theta) = R ghat(theta);
    the magnitude column w_M = Linv 1 and, for a sampled H0, the uniform
    shift column P_g 1_K are fixed, so ``make_linear_chi2`` covers the
    term with beta = 1 and gamma = (mag - offset_ref, -5 log10(H0/h_ref)).
    """
    from cosmax_torch.models.distances import make_prefix_comoving_integral
    from cosmax_torch.models.linear_chi2 import _hash_arrays, make_linear_chi2

    geo = _sn_geometry(dataset, mag_param, h0, use_z_hel, cheb_order, cepheids)
    z_nodes, p_mat, i_ref = geo["z_nodes"], geo["p_mat"], geo["i_ref"]
    u_ref, offset_ref, h0_ref = geo["u_ref"], geo["offset_ref"], geo["h0_ref"]

    k = z_nodes.size
    p_g = p_mat[:, :k]
    q_basis, r_q = np.linalg.qr(p_g)  # P_g = Q R, Q [N, K] orthonormal
    log10_i_ref = np.log10(i_ref)

    # build-time quadrature: 16-node GL panels between Chebyshev nodes
    build_order = 16

    def curve_fn(flat, to_params):
        prefix = make_prefix_comoving_integral(z_nodes, model, "cpu", torch.float64, build_order)
        integral = prefix(to_params(torch.as_tensor(flat, dtype=torch.float64)))
        ghat = 5.0 * (torch.log10(integral) - torch.as_tensor(log10_i_ref))
        return (ghat @ torch.as_tensor(r_q).T).numpy()

    # fixed residual columns: the magnitude direction, plus the uniform
    # -5 log10(h/h_ref) shift when H0 is sampled (both act only through
    # the hubble-flow basis rows)
    w_cols = [p_mat[:, k]]
    sampled_h0 = isinstance(h0, str)
    if sampled_h0:
        w_cols.append(p_g @ np.ones(k))
    w_full = np.stack(w_cols, axis=1)  # [N, J]

    def gamma_fn(p):
        cols = [p[mag_param] - offset_ref]
        if sampled_h0:
            cols.append(-5.0 * torch.log10(p[h0] / h0_ref))
        return torch.stack(cols, dim=-1)

    chi2 = make_linear_chi2(
        model,
        curve_fn,
        tag=f"sn-{model}",
        key_extra=_hash_arrays(z_nodes, r_q, log10_i_ref) + f"-o{build_order}",
        u0_c=q_basis.T @ u_ref,
        u0_sq=float(u_ref @ u_ref),
        device=device,
        dtype=dtype,
        w_c=q_basis.T @ w_full,
        q0=w_full.T @ u_ref,
        s_mat=w_full.T @ w_full,
        gamma_fn=gamma_fn,
    )
    # the roles of the parameters, for the fused kernel's packer
    gamma = dict(mag=mag_param, offset_ref=offset_ref, h0=h0 if sampled_h0 else None,
                 h0_ref=h0_ref)
    return Term(
        name=name,
        chi2=chi2,
        meta=dict(_sn_meta(dataset, "emulated"), linear_chi2=chi2, gamma=gamma,
                  theory_mag=_basis_theory_mag(geo, model, mag_param, h0, device, dtype)),
    )


def _basis_theory_mag(geo, model, mag_param, h0, device, dtype):
    """mu(p) [W, N] of the emulated path, off the hot path (plots and the
    residual statistics): the compressed representation, 6-node GL panels
    between the Chebyshev nodes and the basis expansion
    const + B~ [g(z_k), mag]."""
    from cosmax_torch.models.distances import make_prefix_comoving_integral

    prefix_integral = make_prefix_comoving_integral(geo["z_nodes"], model, device, dtype, order=6)
    c = constants_from_numpy(dict(b_tilde=geo["b_tilde"], const=geo["const"]), device, dtype)

    def theory_mag(p):
        integral = prefix_integral(p)
        if h0 is None:
            g = 5.0 * torch.log10(C_KM_S * integral)
        else:
            h0_val = p[h0][:, None] if isinstance(h0, str) else h0
            g = 5.0 * torch.log10((C_KM_S / h0_val) * integral)
        coef = torch.cat([g, p[mag_param][:, None]], dim=-1)
        return c["const"] + coef @ c["b_tilde"].T

    return theory_mag
