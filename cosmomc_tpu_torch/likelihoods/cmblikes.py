"""Generic binned CMB power-spectrum likelihood ("CMBLike2" dataset format).

Port of cosmomc_tpu/likelihoods/cmblikes.py (the reference's CMBlikes
engine, source/CMBlikes.f90: CMBLikes_ReadIni, CMBLikes_LogLike,
CMBLikes_Transform, TBinWindows_bin), batched over chains. It reads the
SPT-SZ 2500d TT set, the Planck lensing bandpowers with their linear
corrections, BK-style HL sets and the rest of the `.dataset` zoo.

Load time (host, float64 numpy) parses the `.dataset` ini and builds the
dense operands on the device: the bin windows as one (nbins, nwin, nL)
tensor with a (nwin, ncl) scatter onto the vech columns, the fiducial
matrix roots and the inverse covariance. `log_like(theory, nuisance)`
takes the (C, 4, 4, lmax+1) theory stack and the (C, n) nuisance slice
and returns chi^2/2 per chain, (C,): gather the required spectra,
aberration, foregrounds and calibration, window binning, vech to
matrices, then the Hamimeche-Lewis transform (two batched `eigh` over
(C, nbins, n, n)), the Gaussian form or the fullsky-exact sum, one
quadratic form a chain. A chain whose theory plus noise is not positive
definite in any bin gets +inf, and only that chain.

Theory convention (CosmoTheory.f90 Cls(4,4)): fields T=0 E=1 B=2 P=3,
symmetric in the first two axes, l(l+1)C_l/2pi in muK^2 for T/E/B and
[l(l+1)]^2 C_l^{phi phi}/2pi for P. The likelihood computes in its own
dtype (float64 by default, as the JAX package), casting the theory to it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from cosmomc_tpu_torch import kernels
from cosmomc_tpu_torch.likelihoods.base import Likelihood, read_dataset_ini
from cosmomc_tpu_torch.params.space import Speed
from cosmomc_tpu_torch.utils.ini import IniFile
from cosmomc_tpu_torch.utils.paramnames import ParamNames

CMB_FIELDS = "TEBP"
FIELD_T, FIELD_E, FIELD_B, FIELD_P = 0, 1, 2, 3

LIKE_HL, LIKE_GAUSSIAN, LIKE_EXACT = "HL", "gaussian", "exact"


def field_index(c: str) -> int:
    """T, E, B, P -> 0..3 (reference TypeIndex)."""
    i = CMB_FIELDS.find(c.upper())
    if i < 0:
        raise ValueError(f"invalid C_l field {c!r}, must be one of {CMB_FIELDS}")
    return i


def read_cl_text(path: str, lmax: int) -> np.ndarray:
    """A CAMB-convention spectrum text file (columns L TT TE EE BB [PP], or
    as its '#' header names them) -> the (4, 4, lmax+1) theory stack."""
    dat = np.loadtxt(path)
    with open(path) as f:
        first = f.readline().strip()
    cols = first.lstrip("#").split()[1:] if first.startswith("#") else \
        ["TT", "TE", "EE", "BB", "PP"][: dat.shape[1] - 1]
    cls = np.zeros((4, 4, lmax + 1))
    L = dat[:, 0].astype(int)
    sel = L <= lmax
    for ci, name in enumerate(cols):
        i, j = field_index(name[0]), field_index(name[1])
        cls[max(i, j), min(i, j), L[sel]] = dat[sel, ci + 1]
        cls[min(i, j), max(i, j), L[sel]] = dat[sel, ci + 1]
    return cls


def _sym_sqrt(M: np.ndarray) -> np.ndarray:
    w, V = np.linalg.eigh(M)
    return (V * np.sqrt(np.maximum(w, 0.0))) @ V.T


class _BinWindows:
    """Dense bin-window operand: W (nbins, nwin, nL), the required-pair row
    each window reads and the vech column it adds to (-1: dropped)."""

    def __init__(self, W: np.ndarray, in_pair: np.ndarray, out_col: np.ndarray):
        self.W = W
        self.in_pair = in_pair
        self.out_col = out_col
        self._dev = None

    def to(self, device, dtype, ncl: int) -> "_BinWindows":
        S = np.zeros((len(self.out_col), ncl))
        for w, c in enumerate(self.out_col):
            if c >= 0:
                S[w, c] = 1.0
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self._dev = (t(self.W), torch.as_tensor(self.in_pair, device=device),
                     t(S))
        return self

    def bin(self, cls_req: torch.Tensor) -> torch.Tensor:
        """(C, npair_req, nL) -> (C, nbins, ncl) binned vech vectors; windows
        with the same output column add (as a segment sum)."""
        W, in_pair, S = self._dev
        contrib = torch.einsum("bwl,cwl->cbw", W, cls_req[:, in_pair])
        return contrib @ S


class CMBLikes(Likelihood):
    """Generic binned/unbinned CMB map-cross-spectrum likelihood."""

    kind = "CMB"
    speed = Speed.SLOW

    def __init__(self, dataset_path: str, name: str = "",
                 dataset_overrides: Optional[Dict[str, str]] = None,
                 param_specs: Optional[Dict[str, Sequence[float]]] = None,
                 device="cuda", dtype=torch.float64):
        super().__init__(name or os.path.splitext(os.path.basename(dataset_path))[0])
        self.device = kernels.entry_device(device, type(self).__name__)
        self.dtype = dtype
        ini = read_dataset_ini(dataset_path)
        if dataset_overrides:
            ini.params.update(dataset_overrides)
        self._dataset_dir = os.path.dirname(os.path.abspath(dataset_path))
        self._param_specs = dict(param_specs or {})
        self._read_ini(ini)
        self._to_device()

    # ------------------------------------------------------------------ load

    def _rel(self, ini: IniFile, key: str, required: bool = False) -> Optional[str]:
        v = ini.string(key, required=required)
        if not v:
            return None
        if not os.path.isabs(v):
            v = os.path.join(self._dataset_dir, v)
        return v

    def _read_ini(self, ini: IniFile) -> None:
        fmt = ini.string("dataset_format", "CMBLike2")
        if fmt not in ("", "CMBLike2"):
            raise ValueError(f"{self.name}: unsupported dataset_format {fmt}")

        # map names and fields
        map_names = ini.string_list("map_names")
        if map_names:
            self.has_map_names = True
            self.map_names = map_names
            mf = ini.string_list("map_fields", required=True)
            self.map_fields = [field_index(c) for c in mf]
        else:
            self.has_map_names = False
            self.map_names = list(CMB_FIELDS)
            self.map_fields = list(range(4))

        # used and required maps
        fields_use = ini.string_list("fields_use")
        use_theory_field = [True] * 4
        if fields_use:
            use_theory_field = [False] * 4
            for c in fields_use:
                use_theory_field[field_index(c)] = True
        elif not self.has_map_names:
            raise ValueError(f"{self.name}: must have fields_use or map_names")

        maps_use = ini.string_list("maps_use")
        if maps_use:
            use_map = [False] * len(self.map_names)
            for m in maps_use:
                use_map[self.map_names.index(m)] = True
        else:
            use_map = [use_theory_field[self.map_fields[i]]
                       for i in range(len(self.map_names))]

        require_map = list(use_map)
        req = ini.string_list("maps_required" if self.has_map_names
                              else "fields_required")
        if req:
            for m in req:
                if self.has_map_names:
                    require_map[self.map_names.index(m)] = True
                else:
                    for i, nm in enumerate(self.map_names):
                        if nm == m:
                            require_map[i] = True

        self.use_map, self.require_map = use_map, require_map
        self.nmaps = sum(use_map)
        self.nmaps_required = sum(require_map)
        # map index -> used / required position (-1 = not used / required)
        self.map_used_index = np.full(len(self.map_names), -1, int)
        self.map_required_index = np.full(len(self.map_names), -1, int)
        self.required_order: List[int] = []
        ix = 0
        for i, u in enumerate(use_map):
            if u:
                self.map_used_index[i] = ix
                ix += 1
        ix = 0
        for i, r in enumerate(require_map):
            if r:
                self.map_required_index[i] = ix
                self.required_order.append(i)
                ix += 1
        self.ncl = self.nmaps * (self.nmaps + 1) // 2

        # required cross-pair table: row r <-> (i, j), i >= j, required maps
        self.req_pairs: List[Tuple[int, int]] = []
        self._req_pair_row = np.full((self.nmaps_required, self.nmaps_required),
                                     -1, int)
        for i in range(self.nmaps_required):
            for j in range(i + 1):
                self._req_pair_row[i, j] = len(self.req_pairs)
                self._req_pair_row[j, i] = self._req_pair_row[i, j]
                self.req_pairs.append((i, j))
        # the theory field pair of each required pair
        self.req_theory_pairs = []
        for (i, j) in self.req_pairs:
            f1 = self.map_fields[self.required_order[i]]
            f2 = self.map_fields[self.required_order[j]]
            self.req_theory_pairs.append((max(f1, f2), min(f1, f2)))

        self.like_approx = ini.string("like_approx", required=True)
        if self.like_approx not in (LIKE_HL, LIKE_GAUSSIAN, LIKE_EXACT):
            raise ValueError(f"unknown like_approx {self.like_approx}")

        self.pcl_lmin = ini.int("cl_lmin", required=True)
        self.pcl_lmax = ini.int("cl_lmax", required=True)
        self.binned = ini.bool("binned", required=True)
        if not self.binned and self.nmaps != self.nmaps_required:
            # the unbinned path indexes required-pair rows with used-map
            # indices; the reference refuses this too
            raise ValueError(f"{self.name}: unbinned datasets must have "
                             "required maps == used maps")
        self.nL = self.pcl_lmax - self.pcl_lmin + 1

        if self.binned:
            self.nbins = ini.int("nbins", 0)
            self.bin_min = ini.int("use_min", 1)
            self.bin_max = ini.int("use_max", self.nbins)
        else:
            self.nbins = self.nL
            self.bin_min = ini.int("use_min", self.pcl_lmin)
            self.bin_max = ini.int("use_max", self.pcl_lmax)
        self.nbins_used = self.bin_max - self.bin_min + 1

        self.aberration_coeff = ini.float("aberration_coeff", 0.0)

        self.bin_windows = (self._read_bin_windows(ini, "bin_window")
                            if self.binned else None)

        cl_hat = self._read_cl_arr(ini, "cl_hat", required=True)

        self.cl_fiducial = None
        self.fullsky_exact_fksy = 1.0
        if self.like_approx == LIKE_HL:
            self.cl_fiducial = self._read_cl_arr(ini, "cl_fiducial", required=True)
        elif self.like_approx == LIKE_EXACT:
            self.fullsky_exact_fksy = ini.float("fullsky_exact_fksy", 1.0)

        includes_noise = ini.bool("cl_hat_includes_noise", False)
        self.cl_noise = None
        if self.like_approx != LIKE_GAUSSIAN or includes_noise:
            noise = self._read_cl_arr(ini, "cl_noise", required=True)
            if not includes_noise:
                cl_hat = cl_hat + noise
                self.cl_noise = noise
            elif self.like_approx == LIKE_GAUSSIAN:
                cl_hat = cl_hat - noise
            else:
                self.cl_noise = noise
        self.cl_hat = cl_hat

        # vech <-> matrix index plan over the used maps
        tri = np.tril_indices(self.nmaps)
        self._tri_i, self._tri_j = tri[0], tri[1]

        self.chat_m = self._vech_to_mats(cl_hat)          # (nbins_used, n, n)
        self.noise_m = (self._vech_to_mats(self.cl_noise)
                        if self.cl_noise is not None else None)
        self.sqrt_fiducial = None
        if self.cl_fiducial is not None:
            fid = self.cl_fiducial
            if not ini.bool("cl_fiducial_includes_noise", False):
                fid = fid + self.cl_noise
            mats = self._vech_to_mats(fid)
            self.sqrt_fiducial = np.stack([_sym_sqrt(M) for M in mats])

        if self.like_approx != LIKE_EXACT:
            self._read_covmat(ini)
        else:
            self.inv_covariance = None
            self.cl_use_index = np.arange(self.ncl)
            self.ncl_used = self.ncl

        # linear bandpower corrections (Planck lensing): CL_bin +=
        # window.CL - fiducial
        self.fiducial_correction = None
        self.correction_windows = None
        if ini.string("linear_correction_fiducial_file"):
            self.fiducial_correction = self._read_cl_arr(
                ini, "linear_correction_fiducial", required=True)
            self.correction_windows = self._read_bin_windows(
                ini, "linear_correction_bin_window")

        # calibration: its parameter is appended last to the nuisance list
        self.calibration_index = -1
        self.log_calibration_prior = ini.float("log_calibration_prior", -1.0)
        cal_file = self._rel(ini, "calibration_param")
        if cal_file:
            self.add_nuisance_from_paramnames(
                cal_file, defaults=dict(self._param_specs))
            self.calibration_index = len(self.nuisance) - 1

        # required pairs of T/E/B alone: calibrated, aberration-corrected
        self.cmb_pair_mask = np.array(
            [f1 <= FIELD_B and f2 <= FIELD_B
             for (f1, f2) in self.req_theory_pairs])

    def add_nuisance_from_paramnames(self, path, ini=None, defaults=None):
        """As the base class, with calibration-like defaults centred at 1
        for parameters no spec names."""
        defaults = dict(defaults or {})
        for info in ParamNames.from_file(path).sampled():
            if info.name not in defaults and info.name not in self._param_specs:
                defaults[info.name] = (1.0, 0.5, 1.5, 0.002, 0.002)
        defaults.update(self._param_specs)
        super().add_nuisance_from_paramnames(path, ini=ini, defaults=defaults)

    def _to_device(self) -> None:
        """The operands log_like reads, on the device in the likelihood's
        dtype."""
        t = lambda a: (None if a is None else
                       torch.as_tensor(a, dtype=self.dtype, device=self.device))
        it = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.device)
        for w in (self.bin_windows, self.correction_windows):
            if w is not None:
                w.to(self.device, self.dtype, self.ncl)
        self._t_fid_corr = t(self.fiducial_correction)
        self._t_chat = t(self.chat_m)
        self._t_noise = t(self.noise_m)
        self._t_sqrt_fid = t(self.sqrt_fiducial)
        self._t_icov = t(self.inv_covariance)
        self._t_cmb_mask = torch.as_tensor(self.cmb_pair_mask,
                                           device=self.device)[:, None]
        f1 = [p[0] for p in self.req_theory_pairs]
        f2 = [p[1] for p in self.req_theory_pairs]
        self._t_f1, self._t_f2 = it(f1), it(f2)
        self._t_tri_i, self._t_tri_j = it(self._tri_i), it(self._tri_j)
        self._t_use_idx = it(self.cl_use_index)
        self._t_unbinned_rows = it([self._req_pair_row[i, j]
                                    for i in range(self.nmaps)
                                    for j in range(i + 1)])
        self._t_ells = torch.arange(self.pcl_lmin, self.pcl_lmax + 1,
                                    dtype=self.dtype, device=self.device)
        self._t_bin_ls = torch.arange(self.bin_min, self.bin_max + 1,
                                      dtype=self.dtype, device=self.device)

    # --- file readers ----------------------------------------------------

    def _pair_to_used(self, s: str) -> Tuple[int, int]:
        """'TE' or 'mapAxmapB' -> used-map indices (i >= j), -1 if unused."""
        return self._pair_to_index(s, self.map_used_index)

    def _pair_to_index(self, s: str, index: np.ndarray) -> Tuple[int, int]:
        if "x" in s and self.has_map_names:
            a, b = s.split("x", 1)
            i1, i2 = self.map_names.index(a), self.map_names.index(b)
        elif len(s) == 2 and not self.has_map_names:
            i1, i2 = self.map_names.index(s[0]), self.map_names.index(s[1])
        elif "x" in s:
            a, b = s.split("x", 1)
            i1, i2 = self.map_names.index(a), self.map_names.index(b)
        else:
            raise ValueError(f"{self.name}: invalid spectrum name {s!r}")
        i1, i2 = index[i1], index[i2]
        return (i1, i2) if i1 >= i2 else (i2, i1)

    def _cols_from_order(self, order: Sequence[str]) -> np.ndarray:
        """Column in `order` of each used vech element (-1 = absent)
        (reference GetColsFromOrder)."""
        used = [self.map_names[i] for i, u in enumerate(self.use_map) if u]
        cols = np.full(self.ncl, -1, int)
        ix = 0
        for i in range(self.nmaps):
            for j in range(i + 1):
                a, b = used[i], used[j]
                cands = ([a + "x" + b, b + "x" + a] if self.has_map_names
                         else [a + b, b + a])
                for c in cands:
                    if c in order:
                        cols[ix] = order.index(c)
                        break
                ix += 1
        return cols

    def _read_cl_arr(self, ini: IniFile, stem: str, required: bool = False
                     ) -> Optional[np.ndarray]:
        """A bandpower/noise/fiducial C_l file -> (nbins_used, ncl)
        (reference CMBLikes_ReadClArr)."""
        path = self._rel(ini, stem + "_file", required=required)
        if path is None:
            return None
        order = ini.string(stem + "_order")
        if not order:
            with open(path) as f:
                first = ""
                for line in f:
                    if line.strip().startswith("#"):
                        first = line.strip().lstrip("#").strip()
                    else:
                        break
            if not first:
                raise ValueError(f"No column order given for {path}")
            # the first token names the index column ('L' or 'bin')
            cols_s = first.split()[1:]
        else:
            cols_s = order.split()
        cols = self._cols_from_order(cols_s)
        dat = np.loadtxt(path)
        if dat.ndim == 1:
            dat = dat[None, :]
        out = np.zeros((self.nbins_used, self.ncl))
        rows = dat[:, 0].astype(int)
        sel = (rows >= self.bin_min) & (rows <= self.bin_max)
        if rows[sel].max(initial=-1) < self.bin_max:
            raise ValueError(f"{path}: C_l file does not reach bin {self.bin_max}")
        for ix in range(self.ncl):
            if cols[ix] >= 0:
                out[rows[sel] - self.bin_min, ix] = dat[sel, cols[ix] + 1]
        return out

    def _read_bin_windows(self, ini: IniFile, stem: str) -> _BinWindows:
        fn = self._rel(ini, stem + "_files", required=True)
        order1 = ini.string(stem + "_in_order", required=True).split()
        order2 = (ini.string(stem + "_out_order") or " ".join(order1)).split()
        if len(order1) != len(order2):
            raise ValueError(f"{stem}: in_order/out_order length mismatch")
        in_pairs = [self._pair_to_index(s, self.map_required_index)
                    for s in order1]
        # the vech column over used maps of each window (repeats add, e.g.
        # the lensing correction's out_order "PP PP PP PP")
        out_for_win = np.full(len(order2), -1, int)
        for w, nm in enumerate(order2):
            i, j = self._pair_to_index(nm, self.map_used_index)
            if i >= 0 and j >= 0:
                out_for_win[w] = i * (i + 1) // 2 + j
        W = np.zeros((self.nbins_used, len(order1), self.nL))
        for b in range(self.bin_min, self.bin_max + 1):
            path = fn.replace("%u", str(b)).replace("%d", str(b))
            dat = np.loadtxt(path)
            if dat.ndim == 1:
                dat = dat[None, :]
            L = dat[:, 0].astype(int)
            sel = (L >= self.pcl_lmin) & (L <= self.pcl_lmax)
            W[b - self.bin_min, :, L[sel] - self.pcl_lmin] = dat[sel, 1:]
        in_pair_rows = np.array([self._req_pair_row[i, j] if i >= 0 and j >= 0
                                 else -1 for (i, j) in in_pairs])
        keep = in_pair_rows >= 0
        return _BinWindows(W[:, keep, :], in_pair_rows[keep], out_for_win[keep])

    def _read_covmat(self, ini: IniFile) -> None:
        """(reference ReadCovmat)."""
        covmat_cl = ini.string("covmat_cl", required=True).split()
        path = self._rel(ini, "covmat_fiducial", required=True)
        scale = ini.float("covmat_scale", 1.0)
        cl_in_index = self._cols_from_order_pairs(covmat_cl)
        num_in = len(cl_in_index)
        used = [(k, c) for k, c in enumerate(cl_in_index) if c >= 0]
        self.ncl_used = len(used)
        self.cl_use_index = np.array([c for _, c in used])
        cov_cl_used = np.array([k for k, _ in used])

        Cov = np.loadtxt(path)
        n = self.nbins_used * self.ncl_used
        out = np.empty((n, n))
        if self.binned:
            for bx in range(self.bin_min, self.bin_max + 1):
                for by in range(self.bin_min, self.bin_max + 1):
                    sub = Cov[np.ix_((bx - 1) * num_in + cov_cl_used,
                                     (by - 1) * num_in + cov_cl_used)]
                    i0 = (bx - self.bin_min) * self.ncl_used
                    j0 = (by - self.bin_min) * self.ncl_used
                    out[i0:i0 + self.ncl_used, j0:j0 + self.ncl_used] = scale * sub
        else:
            vecsize = self.nL
            l0 = self.bin_min - self.pcl_lmin
            for i in range(self.ncl_used):
                for j in range(self.ncl_used):
                    blk = Cov[cov_cl_used[i] * vecsize + l0:
                              cov_cl_used[i] * vecsize + l0 + self.nbins_used,
                              cov_cl_used[j] * vecsize + l0:
                              cov_cl_used[j] * vecsize + l0 + self.nbins_used]
                    out[i::self.ncl_used, j::self.ncl_used] = scale * blk
        self.inv_covariance = np.linalg.inv(out)

    def _cols_from_order_pairs(self, order: Sequence[str]) -> List[int]:
        """For covmat_cl: the used vech column of each named pair, -1 if
        not used."""
        out = []
        for s in order:
            try:
                i, j = self._pair_to_used(s)
            except ValueError:
                out.append(-1)
                continue
            out.append(-1 if i < 0 or j < 0 else i * (i + 1) // 2 + j)
        return out

    def _vech_to_mats(self, vech: Optional[np.ndarray]) -> Optional[np.ndarray]:
        if vech is None:
            return None
        M = np.zeros((self.nbins_used, self.nmaps, self.nmaps))
        M[:, self._tri_i, self._tri_j] = vech
        M[:, self._tri_j, self._tri_i] = vech
        return M

    # ------------------------------------------------------------- theory ops

    def required_lmax(self) -> int:
        return self.pcl_lmax

    def gather_required(self, cls_stack: torch.Tensor) -> torch.Tensor:
        """(C, 4, 4, lmax+1) theory -> (C, npair_req, nL) required map
        cross-spectra (reference GetTheoryMapCls)."""
        return cls_stack[:, self._t_f1, self._t_f2,
                         self.pcl_lmin:self.pcl_lmax + 1].to(self.dtype)

    def add_foregrounds(self, cls_req: torch.Tensor, nuisance: torch.Tensor
                        ) -> torch.Tensor:
        """Hook for subclasses (BK-Planck)."""
        return cls_req

    def _adapt_theory(self, cls_req: torch.Tensor, nuisance: torch.Tensor
                      ) -> torch.Tensor:
        """Aberration, foregrounds, calibration (AdaptTheoryForMaps)."""
        cmb = self._t_cmb_mask
        if self.aberration_coeff:
            ells = self._t_ells
            norm = ells * (ells + 1)
            cl = cls_req / norm
            d = torch.zeros_like(cl)
            d[..., 1:-1] = 0.5 * (cl[..., 2:] - cl[..., :-2])
            d[..., 0] = d[..., 1]
            d[..., -1] = d[..., -2]
            corr = self.aberration_coeff * ells * norm * d
            cls_req = torch.where(cmb, cls_req + corr, cls_req)
        cls_req = self.add_foregrounds(cls_req, nuisance)
        if self.calibration_index >= 0:
            cal = nuisance[:, self.calibration_index]
            cls_req = torch.where(cmb, cls_req / (cal ** 2)[:, None, None],
                                  cls_req)
        return cls_req

    def _binned_theory(self, cls_req: torch.Tensor) -> torch.Tensor:
        """-> (C, nbins_used, ncl) vech vectors."""
        if self.binned:
            out = self.bin_windows.bin(cls_req)
            if self.correction_windows is not None:
                out = out + (self.correction_windows.bin(cls_req)
                             - self._t_fid_corr)
            return out
        # unbinned: the theory at each l; required maps == used maps
        sel = slice(self.bin_min - self.pcl_lmin,
                    self.bin_max - self.pcl_lmin + 1)
        return cls_req[:, self._t_unbinned_rows, sel].transpose(1, 2)

    def theory_vech(self, cls_stack: torch.Tensor, nuisance: torch.Tensor
                    ) -> torch.Tensor:
        """The binned, adapted theory of each chain, (C, nbins_used, ncl)
        over the used maps' vech (noise not added)."""
        nuisance = nuisance.to(self.dtype)
        cls_req = self._adapt_theory(self.gather_required(cls_stack), nuisance)
        return self._binned_theory(cls_req)

    # --------------------------------------------------------------- loglike

    @staticmethod
    def _inv_root(C: torch.Tensor):
        """C^{-1/2} of each symmetric matrix and its eigenvalues."""
        w, V = torch.linalg.eigh(C)
        inv_root = 1.0 / torch.sqrt(torch.clamp(w, min=1e-30))
        return (V * inv_root[..., None, :]) @ V.transpose(-1, -2), w

    def _hl_transform(self, C: torch.Tensor):
        """Batched Hamimeche-Lewis transform (CMBLikes_Transform; HL
        arXiv:0801.0554 eq. 47): X_b = C_f^{1/2} U g(D) U^T C_f^{1/2}, where
        C^{-1/2} Chat C^{-1/2} = U D U^T and g(d) = sign(d-1)
        sqrt(2(d - ln d - 1)). Returns X and each chain's least eigenvalue
        of C."""
        Cih, w = self._inv_root(C)
        M = Cih @ self._t_chat @ Cih
        d, U = torch.linalg.eigh(M)
        g = torch.sign(d - 1.0) * torch.sqrt(2.0 * torch.clamp(
            d - torch.log(torch.clamp(d, min=1e-30)) - 1.0, min=0.0))
        UF = self._t_sqrt_fid @ U
        X = (UF * g[..., None, :]) @ UF.transpose(-1, -2)
        return X, w.amin(dim=(-2, -1))

    def log_like_cls(self, cls_stack: torch.Tensor, nuisance: torch.Tensor
                     ) -> torch.Tensor:
        """chi^2/2 per chain from the (C, 4, 4, lmax+1) theory stack
        (CMBLikes_LogLike)."""
        dtype = self.dtype
        nuisance = nuisance.to(dtype)
        vech = self.theory_vech(cls_stack, nuisance)       # (C, nb, ncl)
        nc = vech.shape[0]
        C = vech.new_zeros(nc, self.nbins_used, self.nmaps, self.nmaps)
        C[:, :, self._t_tri_i, self._t_tri_j] = vech
        C[:, :, self._t_tri_j, self._t_tri_i] = vech
        if self._t_noise is not None:
            C = C + self._t_noise

        if self.like_approx == LIKE_EXACT:
            Cih, w = self._inv_root(C)
            ev = torch.linalg.eigvalsh(Cih @ self._t_chat @ Cih)
            per_l = (ev.sum(-1) - self.nmaps
                     - torch.log(torch.clamp(ev, min=1e-30)).sum(-1))
            chisq = ((2 * self._t_bin_ls + 1) * self.fullsky_exact_fksy
                     * per_l).sum(-1)
            # a theory + noise that is not positive definite is rejected
            wmin = w.amin(dim=(-2, -1))
        else:
            if self.like_approx == LIKE_HL:
                X, wmin = self._hl_transform(C)
            else:
                X, wmin = C - self._t_chat, None
            vecp = X[:, :, self._t_tri_i, self._t_tri_j]     # (C, nb, ncl)
            bigX = vecp[:, :, self._t_use_idx].reshape(nc, -1)
            chisq = ((bigX @ self._t_icov) * bigX).sum(-1)
        if wmin is not None:
            chisq = torch.where(wmin <= 0.0, torch.full_like(chisq, torch.inf),
                                chisq)
        # the log-calibration prior applies whatever like_approx
        if self.log_calibration_prior > 0 and self.calibration_index >= 0:
            chisq = chisq + (torch.log(nuisance[:, self.calibration_index])
                             / self.log_calibration_prior) ** 2
        return 0.5 * chisq

    def log_like(self, theory, nuisance: torch.Tensor) -> torch.Tensor:
        return self.log_like_cls(theory.cls, nuisance)
