"""Physical constants (SI + astro), CODATA values.

Same numerical contract as the reference's camb/constants.f90 (the values
are physics, not code). Units noted per constant.
"""

import numpy as np

c = 2.99792458e8                  # m / s
G = 6.6738e-11                    # m^3 / kg / s^2
h_planck = 6.62606957e-34         # J s
k_B = 1.3806488e-23               # J / K
sigma_boltz = 5.6704e-8           # W / m^2 / K^4 (Stefan-Boltzmann)
sigma_thomson = 6.6524616e-29     # m^2
m_e = 9.10938291e-31              # kg
m_H = 1.673575e-27                # kg
m_p = 1.672621777e-27             # kg
mass_ratio_He_H = 3.9715          # m_He / m_H

Mpc = 3.085678e22                 # m
Gyr = 3.1556926e16 * 1e9 / 1e9    # s in a year * 1e9 -> use seconds per Gyr
Gyr = 1e9 * 3.1556926e7           # s

kappa = 8.0 * np.pi * G
a_rad = 4.0 * sigma_boltz / c     # radiation constant: rho_gamma = a_rad T^4 / c^2

COBE_CMBTemp = 2.7255             # K default T_CMB
default_nnu = 3.046

zeta3 = 1.2020569031595942854
zeta5 = 1.0369277551433699263
zeta7 = 1.0083492773819228268

# int q^3 /(e^q+1) dq = 7 pi^4 / 120
nu_const = 7.0 / 120.0 * np.pi ** 4
# converts omnuh2 into sum m_nu in eV (camb/modules.f90:1493)
neutrino_mass_fac = 94.07

eV = 1.60217657e-19               # J

# Omega_gamma h^2 for T_CMB: 8 pi G /(3 (100 km/s/Mpc)^2) * a_rad T^4 / c^2
def omega_gamma_h2(tcmb: float = COBE_CMBTemp) -> float:
    H100 = 1e5 / Mpc              # 100 km/s/Mpc in 1/s
    rho_gamma = a_rad * tcmb ** 4 / c ** 2   # kg / m^3
    return kappa / 3.0 * rho_gamma / H100 ** 2


# per massless-neutrino species (before nnu degeneracy factor)
def omega_nu_massless_h2_per_species(tcmb: float = COBE_CMBTemp) -> float:
    return 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * omega_gamma_h2(tcmb)


# H-nuclei number density today per unit ombh2/mu_H [1/m^3]:
#   n_H0 = 3 H0_si^2 (ombh2/h^2) / (kappa mu_H m_H)
#        = NNOW_PREFAC * ombh2 / mu_H      (H0_si^2/h^2 = (1e5/Mpc)^2)
# Folding every tiny SI constant into one Python-float prefactor keeps
# float32 arithmetic away from the denormal range: an intermediate ~1e-37
# flushes to zero where denormals are off, silently zeroing the whole
# thermal history.
NNOW_PREFAC = 3.0 * (1e5 / Mpc) ** 2 / (kappa * m_H)


def n_H_today(ombh2, mu_H):
    """n_H(z=0) [1/m^3] from ombh2 and mu_H = 1/(1-Y_He)."""
    return NNOW_PREFAC * ombh2 / mu_H
