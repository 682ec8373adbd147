"""Background cosmology: H(a), distances, sound horizon, theta_MC.

Port of cosmomc_tpu/models/background.py (camb/modules.f90 ModelParams +
equations_ppf.f90 dtauda; Calculator_Cosmology.f90 distance API). Every
parameter field is a (C,) tensor, one entry per chain; functions of a grid
take the grid with the chains axis first, (C, M), and broadcast the
parameters over it.

  (H(a)/H100)^2 a^4 = omkh2 a^2 + (ombh2+omch2) a + og h2 + onu_massless h2
                      + onu per eigenstate * rho_nu(a m) + odeh2 f_de(a) a^4
  f_de(a) = a^{-3(1+w0+wa)} exp(-3 wa (1-a))
  theta_MC: Hu & Sugiyama z*, r_s from R = 3e4 a ombh2, theta = r_s/D_M
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from cosmomc_tpu_torch.models import constants as const
from cosmomc_tpu_torch.models.neutrino import nu_rho
from cosmomc_tpu_torch.utils.interp import cumsum
from cosmomc_tpu_torch.utils.quad import gl_nodes

# H100 in 1/Mpc (units where c=1): (100 km/s/Mpc) / c
H100_MPC = 1e5 / const.c

BG_FIELDS = ("ombh2", "omch2", "H0", "omk", "omnuh2", "nnu", "w", "wa", "tcmb")


def col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain (C,) value shaped to broadcast against `like` (C, ...)."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


@dataclass
class BackgroundParams:
    """Physical background parameters, each a (C,) tensor.
    `num_massive_nu` selects code paths and is a plain int."""
    ombh2: torch.Tensor
    omch2: torch.Tensor
    H0: torch.Tensor
    omk: torch.Tensor
    omnuh2: torch.Tensor
    nnu: torch.Tensor
    w: torch.Tensor
    wa: torch.Tensor
    tcmb: torch.Tensor
    num_massive_nu: int = 1

    @classmethod
    def make(cls, ombh2=0.0224, omch2=0.120, H0=67.5, omk=0.0, omnuh2=0.000644,
             nnu=3.046, w=-1.0, wa=0.0, tcmb=const.COBE_CMBTemp,
             num_massive_nu=1, nchains=1, device=None, dtype=torch.float64):
        def f(v):
            return torch.as_tensor(v, dtype=dtype, device=device).expand(
                nchains).clone()
        return cls(f(ombh2), f(omch2), f(H0), f(omk), f(omnuh2), f(nnu),
                   f(w), f(wa), f(tcmb), num_massive_nu)


def densities(bg: BackgroundParams) -> dict:
    """Derived Omega h^2 components and neutrino mass parameter, each (C,)."""
    h2 = (bg.H0 / 100.0) ** 2
    ogh2 = const.omega_gamma_h2() * (bg.tcmb / const.COBE_CMBTemp) ** 4
    onu1 = 7.0 / 8.0 * (4.0 / 11.0) ** (4.0 / 3.0) * ogh2
    if bg.num_massive_nu > 0:
        massive_deg = bg.nnu / 3.0
        massless_deg = bg.nnu - massive_deg
        nu_mass = (const.nu_const / (1.5 * const.zeta3) * bg.omnuh2
                   / (onu1 * massive_deg))
    else:
        massive_deg = 0.0 * bg.nnu
        massless_deg = bg.nnu
        nu_mass = torch.zeros_like(bg.ombh2)
    omdeh2 = h2 * (1.0 - bg.omk) - bg.ombh2 - bg.omch2 - bg.omnuh2
    omkh2 = bg.omk * h2
    return dict(h2=h2, ogh2=ogh2, onu1=onu1, massive_deg=massive_deg,
                massless_deg=massless_deg, nu_mass=nu_mass, omdeh2=omdeh2,
                omkh2=omkh2)


def grho_h2_a4(bg: BackgroundParams, a: torch.Tensor) -> torch.Tensor:
    """Total (8 pi G rho / 3 H100^2) a^4 in Omega h^2 units; a is (C, ...)."""
    d = {k: col(v, a) for k, v in densities(bg).items()}
    c = lambda v: col(v, a)
    a2 = a * a
    tot = (d["omkh2"] * a2 + (c(bg.ombh2) + c(bg.omch2)) * a
           + d["ogh2"] + d["onu1"] * d["massless_deg"])
    fde = a ** (1.0 - 3.0 * (1.0 + c(bg.w) + c(bg.wa))) \
        * torch.exp(-3.0 * c(bg.wa) * (1.0 - a)) * a2 * a
    tot = tot + d["omdeh2"] * fde
    if bg.num_massive_nu > 0:
        tot = tot + d["onu1"] * d["massive_deg"] * nu_rho(a * d["nu_mass"])
    return tot


def hubble_mpc(bg: BackgroundParams, a: torch.Tensor) -> torch.Tensor:
    """H(a)/c in 1/Mpc; a is (C, ...)."""
    return H100_MPC * torch.sqrt(grho_h2_a4(bg, a)) / (a * a)


def hofz_kms(bg: BackgroundParams, z) -> torch.Tensor:
    """H(z) in km/s/Mpc at one redshift, per chain: (C,)."""
    a = torch.full_like(bg.H0, 1.0 / (1.0 + z)) if not torch.is_tensor(z) \
        else 1.0 / (1.0 + z)
    return hubble_mpc(bg, a[:, None])[:, 0] * const.c / 1e3


def dtauda(bg: BackgroundParams, a: torch.Tensor) -> torch.Tensor:
    """Conformal time derivative dtau/da in Mpc."""
    return 1.0 / (a ** 2 * hubble_mpc(bg, a))


# ---------------------------------------------------------------------------
# Distances
# ---------------------------------------------------------------------------

N_CHI_GRID = 512
Z_GRID_MAX = 1100.0 * 3


class BackgroundFunctions(NamedTuple):
    """Distance tables per chain on a uniform log(1+z) grid (cumulative
    Simpson + cubic Hermite), each (C, N)."""
    bg: BackgroundParams
    lz_grid: torch.Tensor
    chi_grid: torch.Tensor
    curvature_k: torch.Tensor     # (C,) omk h^2
    dchi_grid: torch.Tensor


def background_functions(bg: BackgroundParams, zmax: float = Z_GRID_MAX,
                         n: int = N_CHI_GRID) -> BackgroundFunctions:
    d = densities(bg)
    ref = bg.ombh2
    lz = torch.linspace(0.0, float(torch.log1p(torch.tensor(zmax,
                                                           dtype=torch.float64))),
                        n, dtype=torch.float64).to(ref.dtype).to(ref.device)
    dx = lz[1] - lz[0]
    lz_all = torch.cat([lz, lz[:-1] + dx / 2.0])
    z_all = torch.expm1(lz_all).expand(ref.shape[0], -1)
    f_all = (1.0 + z_all) / hubble_mpc(bg, 1.0 / (1.0 + z_all))
    f, fm = f_all[:, :n], f_all[:, n:]
    seg = (dx / 6.0) * (f[:, :-1] + 4.0 * fm + f[:, 1:])
    chi = torch.cat([torch.zeros_like(seg[:, :1]), cumsum(seg)], -1)
    return BackgroundFunctions(bg, lz, chi, d["omkh2"], f)


def comoving_radial_distance(bf: BackgroundFunctions, z) -> torch.Tensor:
    """chi(z) in Mpc per chain: z is a float, a (C,) tensor (one redshift a
    chain) or a (C, M) tensor (M redshifts a chain); the result has z's
    shape, (C,) for a float."""
    ref = bf.chi_grid
    z = torch.as_tensor(z, dtype=ref.dtype, device=ref.device)
    if z.dim() == 0:
        z = z.expand(ref.shape[0])
    lz = torch.log1p(z).reshape(ref.shape[0], -1)
    n = ref.shape[-1]
    dx = bf.lz_grid[1] - bf.lz_grid[0]
    t = lz / dx
    i = torch.floor(t).to(torch.int64).clamp(0, n - 2)
    f = (t - i.to(t.dtype)).clamp(0.0, 1.0)
    c0, c1 = bf.chi_grid.gather(-1, i), bf.chi_grid.gather(-1, i + 1)
    d0, d1 = bf.dchi_grid.gather(-1, i) * dx, bf.dchi_grid.gather(-1, i + 1) * dx
    f2 = f * f
    f3 = f2 * f
    chi = ((2 * f3 - 3 * f2 + 1) * c0 + (f3 - 2 * f2 + f) * d0
           + (-2 * f3 + 3 * f2) * c1 + (f3 - f2) * d1)
    return chi.reshape(z.shape)


def rofchi(omkh2: torch.Tensor, chi: torch.Tensor) -> torch.Tensor:
    """Curvature-corrected transverse distance f_K(chi) (modules.f90 rofChi);
    omkh2 is (C,), chi (C,) or (C, M)."""
    omkh2 = col(omkh2, chi)
    flat = omkh2.abs() < 1e-9
    safe = torch.where(flat, 1.0, omkh2.abs())
    sqrtk = torch.sqrt(safe) * H100_MPC
    x = chi * sqrtk
    return torch.where(flat, chi, torch.where(omkh2 > 0, torch.sinh(x) / sqrtk,
                                              torch.sin(x) / sqrtk))


def _redshifts(bf: BackgroundFunctions, z) -> torch.Tensor:
    """z as a tensor on the tables' device: a float becomes (C,)."""
    ref = bf.chi_grid
    z = torch.as_tensor(z, dtype=ref.dtype, device=ref.device)
    return z.expand(ref.shape[0]) if z.dim() == 0 else z


def angular_diameter_distance(bf: BackgroundFunctions, z) -> torch.Tensor:
    """D_A(z) in Mpc (modules.f90 AngularDiameterDistance); z as in
    `comoving_radial_distance`."""
    z = _redshifts(bf, z)
    return rofchi(bf.curvature_k, comoving_radial_distance(bf, z)) / (1.0 + z)


def luminosity_distance(bf: BackgroundFunctions, z) -> torch.Tensor:
    z = _redshifts(bf, z)
    return angular_diameter_distance(bf, z) * (1.0 + z) ** 2


def bao_d_v(bf: BackgroundFunctions, z) -> torch.Tensor:
    """D_V(z) = [(1+z)^2 D_A^2 c z / H]^(1/3) (modules.f90 BAO_D_v)."""
    z = _redshifts(bf, z)
    da = angular_diameter_distance(bf, z)
    zc = z.reshape(z.shape[0], -1)
    hz = hubble_mpc(bf.bg, 1.0 / (1.0 + zc)).reshape(z.shape)   # H/c, 1/Mpc
    return ((1.0 + z) ** 2 * da ** 2 * z / hz) ** (1.0 / 3.0)


# ---------------------------------------------------------------------------
# Sound horizon and theta_MC
# ---------------------------------------------------------------------------

_N_RS = 128


def sound_horizon(bg: BackgroundParams, astar: torch.Tensor) -> torch.Tensor:
    """r_s(a*) with R = 3e4 a ombh2 (modules.f90 dsound_da), per chain."""
    xs, ws = gl_nodes(1e-8 ** 0.5, torch.sqrt(astar), _N_RS)
    a = xs * xs
    R = 3.0e4 * a * bg.ombh2[:, None]
    cs = 1.0 / torch.sqrt(3.0 * (1.0 + R))
    return torch.sum(ws * 2.0 * xs * dtauda(bg, a) * cs, -1)


def z_star_hu_sugiyama(bg: BackgroundParams) -> torch.Tensor:
    ombh2 = bg.ombh2
    omdmh2 = bg.omch2 + bg.omnuh2
    return (1048.0 * (1.0 + 0.00124 * ombh2 ** (-0.738))
            * (1.0 + (0.0783 * ombh2 ** (-0.238) / (1.0 + 39.5 * ombh2 ** 0.763))
               * (omdmh2 + ombh2) ** (0.560 / (1.0 + 21.1 * ombh2 ** 1.81))))


def _chi_direct(bg: BackgroundParams, astar: torch.Tensor, n: int = 160):
    xs, ws = gl_nodes(torch.sqrt(astar), 1.0, n)
    a = xs * xs
    return torch.sum(ws * 2.0 * xs * dtauda(bg, a), -1)


def conformal_time(bg: BackgroundParams, a_end: torch.Tensor, n: int = 192):
    """tau(a_end) per chain, GL in sqrt(a) (the role of CAMB's TimeOfz)."""
    xs, ws = gl_nodes(1e-9 ** 0.5, torch.sqrt(a_end), n)
    a = xs * xs
    return torch.sum(ws * 2.0 * xs * dtauda(bg, a), -1)


def age_gyr(bg: BackgroundParams, n: int = 192) -> torch.Tensor:
    one = torch.ones_like(bg.H0)
    xs, ws = gl_nodes(1e-9 ** 0.5, one, n)
    a = xs * xs
    t_mpc = torch.sum(ws * 2.0 * xs * a * dtauda(bg, a), -1)
    return t_mpc * const.Mpc / const.c / const.Gyr


def z_equality(bg: BackgroundParams) -> torch.Tensor:
    d = densities(bg)
    rad = d["ogh2"] + d["onu1"] * (d["massless_deg"] + d["massive_deg"])
    return (bg.ombh2 + bg.omch2) / rad - 1.0


def cosmomc_theta(bg: BackgroundParams) -> torch.Tensor:
    """theta_MC = r_s(z*)/D_M(z*) per chain (modules.f90 CosmomcTheta)."""
    zstar = z_star_hu_sugiyama(bg)
    astar = 1.0 / (1.0 + zstar)
    rs = sound_horizon(bg, astar)
    chi = _chi_direct(bg, astar)
    return rs / rofchi(densities(bg)["omkh2"], chi)


def h0_from_theta(theta_target: torch.Tensor, make_bg, lo: float = 20.0,
                  hi: float = 120.0, iters: int = 50) -> torch.Tensor:
    """Solve H0 from 100*theta_MC by a fixed-count bisection, then one
    Newton polish step from the midpoint (background.py:333-366). The
    midpoint depends on the inputs only through branch decisions, so its
    derivative is zero; the Newton step mid - f/f_H0 leaves the value
    unchanged and carries the implicit derivative -(df/dp)/(df/dH0), to
    second order as well (f_H0 is differentiable in the inputs)."""
    lo_ = torch.full_like(theta_target, lo)
    hi_ = torch.full_like(theta_target, hi)
    with torch.no_grad():
        for _ in range(iters):
            mid = 0.5 * (lo_ + hi_)
            t = cosmomc_theta(make_bg(mid)) * 100.0
            too_small = t < theta_target
            lo_, hi_ = (torch.where(too_small, mid, lo_),
                        torch.where(too_small, hi_, mid))
    mid = (0.5 * (lo_ + hi_)).detach()
    return newton_polish(
        lambda h: cosmomc_theta(make_bg(h)) * 100.0 - theta_target, mid)


def newton_polish(f_of, mid: torch.Tensor) -> torch.Tensor:
    """One Newton step mid - f(mid)/f'(mid) from a detached root estimate,
    as jax.value_and_grad gives it: f is evaluated from the inputs it
    closes over (and so carries their gradients), f' comes from autograd
    and keeps its own graph when f has one. Without gradients wanted, the
    result carries none."""
    f = f_of(mid)
    with torch.enable_grad():
        x = mid.clone().requires_grad_(True)
        (f_x,) = torch.autograd.grad(f_of(x).sum(), x,
                                     create_graph=f.requires_grad)
    return mid - f / f_x


# ---------------------------------------------------------------------------
# Drag epoch for background-only runs (no thermal history)
# ---------------------------------------------------------------------------

def z_drag_eh(bg: BackgroundParams) -> torch.Tensor:
    """Eisenstein & Hu 1998 Eq. (4) drag redshift fit."""
    ombh2 = bg.ombh2
    omh2 = bg.ombh2 + bg.omch2 + bg.omnuh2
    b1 = 0.313 * omh2 ** (-0.419) * (1.0 + 0.607 * omh2 ** 0.674)
    b2 = 0.238 * omh2 ** 0.223
    return (1291.0 * omh2 ** 0.251 / (1.0 + 0.659 * omh2 ** 0.828)
            * (1.0 + b1 * ombh2 ** b2))


def r_drag_approx(bg: BackgroundParams) -> torch.Tensor:
    """Drag-epoch sound horizon from the Aubourg+2015 fit (1411.1074 Eq. 16),
    used where no thermal history is computed."""
    om_b = bg.ombh2
    om_cb = bg.ombh2 + bg.omch2
    om_nu = bg.omnuh2
    return (55.154 * torch.exp(-72.3 * (om_nu + 0.0006) ** 2)
            / (om_cb ** 0.25351 * om_b ** 0.12807))
