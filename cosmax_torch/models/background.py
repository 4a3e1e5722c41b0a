"""Background expansion E(z) for the dark-energy model family
(counterpart of ``cosmax/models/background.py``).

Models (rho_de(z) / rho_de(0)):

* ``lcdm``    : 1
* ``wcdm``    : (1+z)^{3 (1+w0)}
* ``wzcdm``   : (2 (1+z)^3 / (1 + (1+z)^3))^{2 (1+w0)}
* ``w0wacdm`` : CPL, (1+z)^{3 (1+w0+wa)} exp(-3 wa z / (1+z))

Flat universe; radiation enters only when ``params`` carries ``'Or'``.

``params`` maps names to Python floats or tensors that broadcast against
``z``: a walker batch is a leading axis, so a [W] parameter meets a grid
``z`` [N, L] as [W, 1, 1] (see ``expand_params``).
"""

import torch

MODELS = ("lcdm", "wcdm", "wzcdm", "w0wacdm")


def expand_params(params: dict, n: int) -> dict:
    """Append ``n`` singleton axes to every tensor in ``params`` so that
    [W] walker values broadcast against an ``n``-dimensional grid."""
    if n == 0:
        return params
    out = {}
    for k, v in params.items():
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            v = v.reshape(v.shape + (1,) * n)
        out[k] = v
    return out


def de_density(z, params, model: str):
    """rho_de(z) / rho_de(0). Parameter-dependent powers are written as
    exp(k * log(base)), the reference's form, so that f32 rounding
    follows it."""
    if model == "lcdm":
        return torch.ones_like(z)
    one_plus_z = 1.0 + z
    if model == "wcdm":
        w0 = params["w0"]
        return torch.exp(3.0 * (1.0 + w0) * torch.log(one_plus_z))
    if model == "wzcdm":
        w0 = params["w0"]
        cubed = one_plus_z**3
        return torch.exp(2.0 * (1.0 + w0) * torch.log(2.0 * cubed / (1.0 + cubed)))
    if model == "w0wacdm":
        w0, wa = params["w0"], params["wa"]
        return torch.exp(
            3.0 * (1.0 + w0 + wa) * torch.log(one_plus_z)
            - 3.0 * wa * z / one_plus_z
        )
    raise ValueError(f"unknown model {model!r}; expected one of {MODELS}")


def e2_of_z(z, params, model: str):
    """E^2(z) = Or (1+z)^4 + Om (1+z)^3 + (1 - Om - Or) rho_de (Or = 0
    without radiation)."""
    om = params["Om"]
    one_plus_z = 1.0 + z
    cubed = one_plus_z**3
    rho = de_density(z, params, model)
    if "Or" in params:
        o_r = params["Or"]
        ode = 1.0 - om - o_r
        return o_r * cubed * one_plus_z + om * cubed + ode * rho
    return om * cubed + (1.0 - om) * rho


def e_of_z(z, params, model: str):
    return torch.sqrt(e2_of_z(z, params, model))


def hubble(z, params, model: str):
    """H(z) in km/s/Mpc; params must carry 'H0'."""
    return params["H0"] * e_of_z(z, params, model)


def omega_r_of(h, om):
    """Matter-radiation-equality parameterisation of Omega_r used by the
    reference's CMB scripts (cmb/data_chen_compression.py:35-41):
    z_eq = 24077.44 Om h^2, Or = Om / (1 + z_eq)."""
    z_eq = 24077.44 * om * h**2
    return om / (1.0 + z_eq)
