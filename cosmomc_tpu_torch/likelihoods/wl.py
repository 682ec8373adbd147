"""Galaxy weak lensing, galaxy-galaxy lensing and clustering 2pt likelihood
(DES 1YR xip/xim/gammat/wtheta; port of cosmomc_tpu/likelihoods/wl.py,
reference source/wl.f90 WL_ReadIni :107-299, calc_theory :409-620).

Limber C_l from the (nonlinear) matter power spectrum,

  q_s(chi, b)   = 3/2 Omega_m H0^2 (1+z) chi int dchi' n_b(chi')(1-chi/chi')
                  [- the DES1YR NLA intrinsic-alignment term]
  q_gal(chi, b) = bias_b n_b(chi) H(z)
  C^XY_l(b1,b2) = int dchi/chi^2 q^X_b1 q^Y_b2 P_m((l+1/2)/chi, z)
  xip/xim  = C^kappa_l . M0 / M4 (1+m_1)(1+m_2)
  gammat   = C^cross_l . M2 (1+m_2)
  wtheta   = C^gg_l . M0
  -logL = 0.5 dvec^T Cov^-1 dvec over the selection-cut data vector

with source and lens photo-z shifts applied to the n(z) tables.

Everything that depends only on the dataset is built on the host at load
(numpy, scipy's `jv`): the selection cuts, the covariance sub-block, and
the fused (n_ls_cl, n_theta) operands M0/M2/M4 that take the C_l on the
coarse ell grid through the cubic spline and the bin-averaged Bessel
functions in one product. The data go to the device once. A call is, per
chain, spline lookups of the shifted n(z), one P(k, z) gather of
(n_ls_cl, n_z) points, two reversed cumulative sums for the lensing
efficiency, the Limber einsums and one gather of the cut data vector with
an index built at load: no kernel, no host copy.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.models import background as bgm
from cosmomc_tpu_torch.models.matterpower import power_at
from cosmomc_tpu_torch.models.theory import in_dtype
from cosmomc_tpu_torch.params.space import Param, Speed
from cosmomc_tpu_torch.utils.interp import cumsum, spline_eval, spline_fit
from cosmomc_tpu_torch.utils.paramnames import ParamNames

MEASUREMENT_NAMES = ["xip", "xim", "gammat", "wtheta"]
M_XIP, M_XIM, M_GAMMAT, M_WTHETA = 0, 1, 2, 3

C_KMS = 299792.458

# baseline DES 1YR nuisance setup (batch3/DES.ini)
DES_PARAM_DEFAULTS: Dict[str, Sequence[float]] = {
    "DES_b1": (1.45, 0.8, 3.0, 0.05, 0.05),
    "DES_b2": (1.55, 0.8, 3.0, 0.05, 0.05),
    "DES_b3": (1.65, 0.8, 3.0, 0.05, 0.05),
    "DES_b4": (1.8, 0.8, 3.0, 0.05, 0.05),
    "DES_b5": (2.0, 0.8, 3.0, 0.05, 0.05),
    "DES_m1": (0.012, -0.1, 0.1, 0.005, 0.005),
    "DES_m2": (0.012, -0.1, 0.1, 0.005, 0.005),
    "DES_m3": (0.012, -0.1, 0.1, 0.005, 0.005),
    "DES_m4": (0.012, -0.1, 0.1, 0.005, 0.005),
    "DES_AIA": (1.0, -5.0, 5.0, 0.2, 0.2),
    "DES_alphaIA": (1.0, -5.0, 5.0, 0.2, 0.2),
    "DES_z0AI": (0.62,),
    "DES_DzL1": (0.002, -0.05, 0.05, 0.005, 0.005),
    "DES_DzL2": (0.001, -0.05, 0.05, 0.005, 0.005),
    "DES_DzL3": (0.003, -0.05, 0.05, 0.005, 0.005),
    "DES_DzL4": (0.0, -0.05, 0.05, 0.005, 0.005),
    "DES_DzL5": (0.0, -0.05, 0.05, 0.005, 0.005),
    "DES_DzS1": (-0.001, -0.1, 0.1, 0.005, 0.005),
    "DES_DzS2": (-0.019, -0.1, 0.1, 0.005, 0.005),
    "DES_DzS3": (0.009, -0.1, 0.1, 0.005, 0.005),
    "DES_DzS4": (-0.018, -0.1, 0.1, 0.005, 0.005),
}
DES_PRIORS = {
    "DES_m1": (0.012, 0.023), "DES_m2": (0.012, 0.023),
    "DES_m3": (0.012, 0.023), "DES_m4": (0.012, 0.023),
    "DES_DzL1": (0.002, 0.007), "DES_DzL2": (0.001, 0.007),
    "DES_DzL3": (0.003, 0.006), "DES_DzL4": (0.0, 0.01),
    "DES_DzL5": (0.0, 0.01),
    "DES_DzS1": (-0.001, 0.016), "DES_DzS2": (-0.019, 0.013),
    "DES_DzS3": (0.009, 0.011), "DES_DzS4": (-0.018, 0.022),
}


def _ls_cl_grid(lmax: int, acc: float = 1.0) -> np.ndarray:
    """Coarse ell grid for the Limber C_l (WL_ReadIni :285-297)."""
    out = list(range(2, 100 - int(4 / acc), max(1, int(4 / acc))))
    i = 0
    while out[-1] < lmax:
        out.append(int(round(100 * np.exp(0.1266 * i / acc))))
        i += 1
    return np.array(out, float)


def _bessel_bins(lmax: int, acc: float = 1.0):
    """Log-binned ell groups for the Bessel sums (init_bessel_integration
    :320-347): (ls_bessel midpoints, lmin, lmax per bin)."""
    n = int(500 * acc)
    dlog = np.log(lmax) / n
    ell_last = 1
    dells = []
    for i in range(1, n + 1):
        e = int(np.exp(i * dlog))
        if e != ell_last:
            dells.append(e - ell_last)
            ell_last = e
    mins, maxs, mids = [], [], []
    ell = 2
    for d in dells:
        mids.append((2 * ell + d - 1.0) / 2)
        mins.append(ell)
        maxs.append(ell + d - 1)
        ell += d
    return np.array(mids), np.array(mins), np.array(maxs)


def _spline_basis_matrix(x_knots: np.ndarray, x_eval: np.ndarray
                         ) -> np.ndarray:
    """Matrix S with S @ y == natural-cubic-spline(x_knots, y)(x_eval): the
    spline is linear in y, so S's columns are the splines of the unit
    vectors, fitted in one batched call."""
    n = len(x_knots)
    xk = torch.as_tensor(x_knots, dtype=torch.float64)
    sp = spline_fit(xk, torch.eye(n, dtype=torch.float64))
    return spline_eval(sp, torch.as_tensor(x_eval, dtype=torch.float64)
                       ).numpy().T


class WLLikelihood(Likelihood):
    """DES-style 2pt function likelihood (wl.f90 WLLikelihood)."""

    kind = "WL"
    speed = Speed.SLOW
    #: theory requirements (CosmologyTypes.f90 TCosmologyRequirements)
    needs_matter_power = True

    def __init__(self, dataset_path: str, name: str = "",
                 dataset_overrides: Optional[Dict[str, str]] = None,
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 use_non_linear: bool = True, acc: float = 1.0,
                 device="cuda", dtype=torch.float64):
        self.device = kernels.entry_device(device, "WLLikelihood")
        super().__init__(name or "DES")
        self.dtype = dtype
        self.use_non_linear = use_non_linear
        self.acc = acc
        ini = read_dataset_ini(dataset_path)
        if dataset_overrides:
            ini.params.update(dataset_overrides)
        self._dir = os.path.dirname(os.path.abspath(dataset_path))
        self._read_ini(ini, param_specs)
        self._to_device()

    def _rel(self, ini, key):
        v = ini.string(key, required=True)
        return v if os.path.isabs(v) else os.path.join(self._dir, v)

    # ------------------------------------------------------------------ load

    def _read_ini(self, ini, param_specs) -> None:
        if ini.string("measurements_format", required=True) != "DES":
            raise ValueError("WL: unknown measurements_format")
        self.num_z_bins = ini.int("num_z_bins", required=True)
        self.num_gal_bins = ini.int("num_gal_bins", 0)
        maxbin = max(self.num_z_bins, self.num_gal_bins)
        self.kmax = ini.float("kmax", required=True)
        self.lmax = ini.int("lmax", 50000)

        # source/lens n(z): columns Z_LOW Z_MID Z_HIGH BIN1.. (:141-170),
        # two nodes appended past the last bin, where n = 0
        nz = np.loadtxt(self._rel(ini, "nz_file"))
        nzp = nz.shape[0] + 2
        z_p = np.empty(nzp)
        z_p[:-2] = nz[:, 1]
        z_p[-2] = 2 * z_p[-3] - z_p[-4]
        z_p[-1] = 3 * z_p[-3] - 2 * z_p[-4]
        self.z_p = z_p
        self.num_z_p = nzp

        def nz_table(tab, nbins):
            y = np.zeros((nbins, nzp))
            y[:, :-2] = tab[:, 3:3 + nbins].T
            return y

        self.required_zmax = float(z_p[-1])
        self.p_nz = nz_table(nz, self.num_z_bins)          # (ns, nzp)
        if self.num_gal_bins > 0:
            nzg = np.loadtxt(self._rel(ini, "nz_gal_file"))
            if nzg.shape[0] != nzp - 2 or np.any(nzg[:, 1] != z_p[:-2]):
                raise ValueError("wl assumes windows use the same z bins")
            self.pgal_nz = nz_table(nzg, self.num_gal_bins)
        else:
            self.pgal_nz = None

        self.theta_bins = np.loadtxt(self._rel(ini, "theta_bins_file"))
        self.num_theta_bins = ini.int("num_theta_bins",
                                      len(self.theta_bins))
        theta_rad = self.theta_bins / 60 * np.pi / 180

        self.ia_model = ini.string("intrinsic_alignment_model", "DES1YR")

        self.data_types = [MEASUREMENT_NAMES.index(t) for t in
                           ini.string_list("data_types", required=True)]
        used = ini.string_list("used_data_types")
        self.used_types = ([MEASUREMENT_NAMES.index(t) for t in used]
                           if used else list(self.data_types))

        # selection cuts (:207-221)
        sel = {}
        with open(self._rel(ini, "data_selection")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                sel[(MEASUREMENT_NAMES.index(parts[0]), int(parts[1]),
                     int(parts[2]))] = (float(parts[3]), float(parts[4]))

        # measurements + cut bookkeeping (:223-266)
        cov_ix = 0
        self.corr_data = np.zeros((self.num_theta_bins, maxbin, maxbin,
                                   len(self.data_types)))
        self.bin_pairs: List[List[Tuple[int, int]]] = []
        used_indices, used_items = [], []
        for ti, tp in enumerate(self.data_types):
            pairs = []
            last = None
            dat = np.loadtxt(self._rel(ini,
                                       f"measurements[{MEASUREMENT_NAMES[tp]}]"))
            for row in dat:
                b1, b2, tb = int(row[0]), int(row[1]), int(row[2])
                cov_ix += 1
                if (b1, b2) != last:
                    pairs.append((b1, b2))
                    last = (b1, b2)
                self.corr_data[tb - 1, b1 - 1, b2 - 1, ti] = row[3]
                if tp in self.used_types:
                    rng = sel.get((tp, b1, b2), (-1.0, -1.0))
                    th = self.theta_bins[tb - 1]
                    if rng[0] <= th <= rng[1]:
                        used_indices.append(cov_ix - 1)
                        used_items.append((ti, b1 - 1, b2 - 1, tb - 1))
            self.bin_pairs.append(pairs)
        self.used_indices = np.array(used_indices, int)
        self.used_items = np.array(used_items, int)
        self.num_used = len(used_indices)

        cov = np.loadtxt(self._rel(ini, "cov_file"))
        if cov.shape != (cov_ix, cov_ix):
            raise ValueError("WL: cov size does not match data size")
        sub = cov[np.ix_(self.used_indices, self.used_indices)]
        sub = sub * ini.float("ah_factor", 1.0)
        self.inv_cov = np.linalg.inv(sub)
        it = self.used_items.T
        self.data_vector = self.corr_data[it[3], it[1], it[2], it[0]]

        # Limber ell grid + fused spline/Bessel operands (cl2corr)
        self.ls_cl = _ls_cl_grid(self.lmax, self.acc)
        mids, lmins, lmaxs = _bessel_bins(self.lmax, self.acc)
        from scipy.special import jv
        nth = self.num_theta_bins
        J = {0: np.zeros((len(mids), nth)), 2: np.zeros((len(mids), nth)),
             4: np.zeros((len(mids), nth))}
        for i, (lo, hi) in enumerate(zip(lmins, lmaxs)):
            ells = np.arange(lo, hi + 1)
            x = ells[:, None] * theta_rad[None, :]
            for order in (0, 2, 4):
                J[order][i] = (ells[:, None] * jv(order, x)).sum(0) / (2 * np.pi)
        S = _spline_basis_matrix(self.ls_cl, mids)     # (nb, ncl)
        # fused (ncl, ntheta) operands: corr(theta) = C_l @ M
        self.M0 = S.T @ J[0]
        self.M2 = S.T @ J[2]
        self.M4 = S.T @ J[4]

        # nuisance parameters (batch3/DES.ini defaults + priors)
        specs = dict(DES_PARAM_DEFAULTS)
        specs.update(param_specs or {})
        pn = ParamNames.from_file(self._rel(ini, "nuisance_params"))
        for info in pn.sampled():
            spec = specs[info.name]
            if len(spec) == 1:
                p = Param(info.name, spec[0], spec[0], spec[0], 0.0, 0.0,
                          label=info.label, speed=Speed.FAST)
            else:
                p = Param(info.name, *spec[:5], label=info.label,
                          speed=Speed.FAST)
                if info.name in DES_PRIORS:
                    p.prior_mean, p.prior_std = DES_PRIORS[info.name]
            self.nuisance.append(p)

    def _to_device(self) -> None:
        """The static tables on the device, once; the cut data vector's
        gather index into the flattened correlation functions."""
        ns, ng, nt = self.num_z_bins, self.num_gal_bins, self.num_theta_bins
        shapes = {M_XIP: (ns, ns), M_XIM: (ns, ns), M_GAMMAT: (ng, ns),
                  M_WTHETA: (ng, ng)}
        self._types = [tp for tp in range(4) if tp in self.used_types]
        offset, base = 0, {}
        for tp in self._types:
            base[tp] = offset
            offset += nt * shapes[tp][0] * shapes[tp][1]
        index = [base[self.data_types[ti]]
                 + (tb * shapes[self.data_types[ti]][0] + b1)
                 * shapes[self.data_types[ti]][1] + b2
                 for (ti, b1, b2, tb) in self.used_items]
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                      device=self.device)
        self._index = torch.as_tensor(index, dtype=torch.int64,
                                      device=self.device)
        self._z_p, self._ls = t(self.z_p), t(self.ls_cl)
        # the growth normalisation's query, P(k = 0.01/Mpc, z = 0)
        self._k_growth, self._z0 = t([0.01]), t([0.0])
        self._M = {0: t(self.M0), 2: t(self.M2), 4: t(self.M4)}
        self._icov, self._data = t(self.inv_cov), t(self.data_vector)
        zk = self._z_p
        self._p_sp = spline_fit(zk, t(self.p_nz))
        self._pgal_sp = (spline_fit(zk, t(self.pgal_nz))
                         if self.pgal_nz is not None else None)

    # ---------------------------------------------------------------- theory

    def required_lmax(self) -> int:
        return 0      # needs P(k,z), not C_l

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        vec = self.theory_vector(theory, nuisance) - self._data
        return 0.5 * ((vec @ self._icov) * vec).sum(-1)

    def _shifted(self, sp, dzs: torch.Tensor, Hs: torch.Tensor):
        """H(z) n_b(z - dz_b) on z_p per chain, zero outside the table
        (:495-512): (C, nz, nb)."""
        z_p = self._z_p
        zq = z_p - dzs[:, :, None]                          # (C, nb, nz)
        v = spline_eval(sp, zq)
        v = torch.where((zq < z_p[0]) | (zq > z_p[-1]), 0.0, v)
        return (Hs[:, None, :] * v).transpose(1, 2)

    def theory_vector(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        """Predicted cut data vector per chain, (C, num_used)."""
        dtype = self.dtype
        theory = in_dtype(theory, dtype)
        mp = theory.mp
        if mp is None:
            raise ValueError(f"{self.name}: theory has no matter power "
                             "(enable matter_power on the posterior)")
        p = self.nuisance_values(nuisance.to(dtype))
        ng, ns = self.num_gal_bins, self.num_z_bins
        bias = p[:, 0:ng]
        shear_m = p[:, ng:ng + ns]
        ia_A, ia_alpha, ia_z0 = (p[:, ng + ns:ng + ns + 1],
                                 p[:, ng + ns + 1:ng + ns + 2],
                                 p[:, ng + ns + 2:ng + ns + 3])
        dz_lens = p[:, ng + ns + 3:2 * ng + ns + 3]
        dz_src = p[:, 2 * ng + ns + 3:2 * ng + 2 * ns + 3]

        bg, bf = theory.bg, theory.bf
        C = p.shape[0]
        z_p = self._z_p
        zc = z_p.expand(C, -1)                               # (C, nz)
        chis = bgm.comoving_radial_distance(bf, zc)
        dchis = torch.cat([(chis[:, 1:2] + chis[:, :1]) / 2,
                           (chis[:, 2:] - chis[:, :-2]) / 2,
                           chis[:, -1:] - chis[:, -2:-1]], -1)
        Hs = bgm.hubble_mpc(bg, 1.0 / (1.0 + zc))           # 1/Mpc
        h = (bg.H0 / 100.0)[:, None]
        omm = (bg.ombh2 + bg.omch2 + bg.omnuh2)[:, None] / h ** 2

        # growth from linear P(k=0.01, z) (calc_theory :480-487)
        Pg = power_at(mp, torch.full_like(z_p, 0.01), z_p)
        D_growth = torch.sqrt(Pg / power_at(mp, self._k_growth, self._z0))
        align_z = ia_A * ((1 + zc) / (1 + ia_z0)) ** ia_alpha \
            * 0.0134 / D_growth

        n_chi = self._shifted(self._p_sp, dz_src, Hs)        # (C, nz, ns)
        qgal = (self._shifted(self._pgal_sp, dz_lens, Hs) * bias[:, None, :]
                if self._pgal_sp is not None else None)

        # lensing efficiency q_s: two reversed cumulative sums replace the
        # reference's triangle loop (:514-521)
        fac = dchis[:, :, None] * n_chi
        rev = lambda x: cumsum(x.flip(1), 1).flip(1)
        qs = rev(fac) - chis[:, :, None] * rev(fac / chis[:, :, None])
        # (100/c_kms)^2 = (H0/h c)^2 in 1/Mpc^2 (wl.f90:523,529)
        h0c2 = (100.0 / C_KMS) ** 2
        if self.ia_model == "DES1YR":
            qs = qs - align_z[:, :, None] * n_chi / (
                chis * (1 + zc) * 3 * h ** 2 * h0c2 / 2)[:, :, None]
        qs = qs * ((1.5 * omm * h ** 2 * h0c2) * chis * (1 + zc))[:, :, None]

        # Limber integrand weights: P over the (ell, z) grid (:537-560)
        ls = self._ls
        nl, nz = ls.shape[0], z_p.shape[0]
        kq = (ls[None, :, None] + 0.5) / chis[:, None, :]   # (C, nl, nz)
        P = power_at(mp, kq.reshape(C, -1), zc.repeat(1, nl),
                     nonlinear=self.use_non_linear).reshape(C, nl, nz)
        khq = kq / h[:, :, None]
        khmin = mp.k[0] / h[:, :, None]
        mask = (khq >= khmin) & (khq <= self.kmax)
        w = torch.where(mask, P, 0.0) * (dchis / chis ** 2)[:, None, :]

        M = self._M
        limber = lambda qa, qb: torch.einsum("clz,czi,czj->clij", w, qa, qb)
        clk = (limber(qs, qs) if M_XIP in self._types or M_XIM in self._types
               else None)
        mfac = ((1 + shear_m[:, :, None]) * (1 + shear_m[:, None, :]))[:, None]
        corrs = []
        for tp in self._types:
            if tp == M_XIP:
                c = torch.einsum("clij,lt->ctij", clk, M[0]) * mfac
            elif tp == M_XIM:
                c = torch.einsum("clij,lt->ctij", clk, M[4]) * mfac
            elif tp == M_GAMMAT:
                c = torch.einsum("clij,lt->ctij", limber(qgal, qs), M[2]) \
                    * (1 + shear_m[:, None, None, :])
            else:
                c = torch.einsum("clij,lt->ctij", limber(qgal, qgal), M[0])
            corrs.append(c.reshape(C, -1))
        # the cut data vector (make_vector :395-407)
        return torch.cat(corrs, -1)[:, self._index]
