"""Physical constants shared across the framework.

Values match the reference suite exactly so that chi^2 parity holds:
* speed of light from scipy.constants, in km/s (reference bao/desi.py:3-6)
* CMB temperature and photon density (reference cmb/data_chen_compression.py:26-32)
"""

# Speed of light in km/s (scipy.constants.c / 1000, exact by SI definition).
C_KM_S = 299792.458

# CMB blackbody temperature [K] (reference cmb/data_chen_compression.py:27).
TCMB = 2.7255

# Photon density parameter omega_gamma h^2 (reference cmb/data_chen_compression.py:28).
O_GAMMA_H2 = (0.75 / 31500.0) * (TCMB / 2.7) ** 4

# Effective number of neutrino species (reference cmb/data_chen_compression.py:26).
N_EFF = 3.046


def omega_r_h2(n_eff: float = N_EFF) -> float:
    """Radiation density omega_r h^2 incl. neutrinos.

    Reference: cmb/data_chen_compression.py:31-32.
    """
    return O_GAMMA_H2 * (1.0 + 0.2271 * n_eff)
