"""Ini-driven composition root + action dispatch: the `cosmomc params.ini`
equivalent (port of cosmomc_tpu/driver.py; reference: source/driver.F90
program CosmoMC + GeneralSetup.f90 TSetup).

Usage:  python -m cosmomc_tpu_torch params.ini [key=value ...]
Actions (driver.F90:269-284 / GeneralSetup.f90:13):
  action = 0  MCMC sampling run (chains + sidecars + converge_stat; with
              sampling_method = hmc the HMC sampler)
  action = 1  importance re-weighting of existing chains (redo_*)
  action = 2  best-fit minimization -> .minimum (+ .hessian.covmat)
  action = 4  likelihood test at fixed point, compare test_check_compare
              within 0.05 (GeneralSetup.f90:146-185: the regression gate)

Ini surface (the JAX driver's, key for key, with its defaults):
  file_root, action, samples, num_chains, feedback, checkpoint,
  MPI_R_Stop, MPI_Max_R_ProposeUpdate, propose_matrix, seed,
  parameterization = theta | background | astro,
  param[name] = center [min max start_width propose_width],
  prior[name] = mean std, use_float64, use_fast_slow, oversample_fast,
  propose_scale, temperature, segment_steps, sampling_method,
  cmb_dataset[tag], pliklite_dataset, bao_dataset[tag], sn_dataset[tag],
  abundance_dataset[tag], use_HST + Hubble_* keys, use_WL, use_mpk,
  use_SZ, lmax, lmax_computed_cl, highL_theory_cl_template,
  use_matter_power, compute_tensors, test_check_compare,
  redo_root / redo_add / post_suffix (action=1), write_stats.
The port's own keys:
  device = cuda | cpu (default cuda; raises without a card),
  bbn_table = <reference-format BBN grid> for the theta and astro
  parameterizations (default $COSMOMC_DATA/PArthENoPE_880.2_standard.dat,
  the JAX package's table).

Action 2 and sampling_method = hmc take gradients through the posterior:
on the background parameterization, and on a CMBPosterior whose slow path
has reverse kernels (`CMBPosterior.gradient_unsupported()` is None: the
flagship CMB configurations with the table line of sight, with or
without matter power, LCDM+r (compute_tensors = T with param[r]),
base_mnu, base_w_wa with or without alpha1, and the LSS-only astro
configuration). With the recurrence line of sight they raise
NotImplementedError before any work. `boltzmann_remat_chunks`
(default 64 for HMC, as JAX's) sets K1's and K5's gradient checkpoints.

Every accessed key is dumped to `<file_root>.inputparams` (provenance,
driver.F90:188-202).
"""

from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cosmomc_tpu_torch.params.space import Param, Speed
from cosmomc_tpu_torch.utils.ini import IniFile

#: the JAX package's BBN table, under $COSMOMC_DATA
DEFAULT_BBN_TABLE = "PArthENoPE_880.2_standard.dat"

#: action 2's Hessian step on a slow-stage posterior, in proposal widths.
#: Its -logL is piecewise smooth (table interpolation, grids that move with
#: the parameters), so its exact gradient carries small jumps; differences
#: over 1e-3 widths gave the flagship indefinite Hessians at its best fit,
#: 0.1 widths the same eigenvalues at two best fits
#: (scripts/flagship_hessian_steps.py)
HESSIAN_STEP = 0.1

#: what action 2 and HMC raise where the slow path lacks reverse kernels
NO_GRADIENT = ("{what} needs gradients through the slow stage, and with "
               "{why} its kernels have no reverse pass yet (ROADMAP.md "
               "queue 1 item 4); the background parameterization, the "
               "flagship CMB configurations, LCDM+r, base_mnu, base_w_wa "
               "and the LSS-only astro configuration have them")


def _require_gradient(post, what: str) -> None:
    """Raise before any work when `post` cannot be differentiated."""
    why = (post.gradient_unsupported()
           if hasattr(post, "gradient_unsupported") else None)
    if why is not None:
        raise NotImplementedError(NO_GRADIENT.format(what=what, why=why))


def build_likelihoods(ini: IniFile, dtype, device):
    """Assemble the likelihood list from ini keys (the registry role of
    DataLikelihoods.f90 SetDataLikelihoods)."""
    from cosmomc_tpu_torch.likelihoods.abundances import AbundanceLikelihood
    from cosmomc_tpu_torch.likelihoods.base import (LikelihoodList,
                                                    read_dataset_ini)
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes
    from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood

    dev = dict(device=device)
    likes = LikelihoodList()
    needs_cls = False
    for tag in ini.tags("abundance_dataset"):
        likes.add(AbundanceLikelihood(
            ini.tagged("abundance_dataset", tag), name=tag,
            bbn_consistency=ini.bool("bbn_consistency", True), **dev))
    for tag in ini.tags("cmb_dataset"):
        path = ini.tagged("cmb_dataset", tag)
        overrides = ini.tag_overrides("cmb_dataset", tag)
        # BK-style datasets declare per-map bandpasses -> foreground model
        # (the reference registers TBK_planck for these, CMB.f90:54-123)
        dsi = read_dataset_ini(path)
        if any(k.startswith("bandpass[") for k in dsi.params):
            from cosmomc_tpu_torch.likelihoods.bkplanck import BKPlanckLikelihood
            likes.add(BKPlanckLikelihood(path, name=tag,
                                         dataset_overrides=overrides,
                                         dtype=dtype, **dev))
        else:
            likes.add(CMBLikes(path, name=tag, dataset_overrides=overrides,
                               dtype=dtype, **dev))
        needs_cls = True
    pl = ini.string("pliklite_dataset")
    if pl:
        likes.add(PlikLiteLikelihood(pl, dtype=dtype, **dev))
        needs_cls = True
    sp = ini.string("sptpol_TEEE_dataset")
    if sp:
        from cosmomc_tpu_torch.likelihoods.sptpol import SPTpolTEEELikelihood
        likes.add(SPTpolTEEELikelihood(sp, dtype=dtype, **dev))
        needs_cls = True
    sp = ini.string("sptpol_BB_dataset")
    if sp:
        from cosmomc_tpu_torch.likelihoods.sptpol import SPTpolBBLikelihood
        likes.add(SPTpolBBLikelihood(sp, dtype=dtype, **dev))
        needs_cls = True
    for tag in ini.tags("bao_dataset"):
        likes.add(BAOLikelihood(ini.tagged("bao_dataset", tag), name=tag,
                                dtype=dtype, **dev))
    for tag in ini.tags("sn_dataset"):
        likes.add(SNLikelihood(ini.tagged("sn_dataset", tag), name=tag,
                               dtype=dtype, **dev))
    if ini.bool("use_WL", False):
        from cosmomc_tpu_torch.likelihoods.wl import WLLikelihood
        for tag in ini.tags("wl_dataset"):
            likes.add(WLLikelihood(
                ini.tagged("wl_dataset", tag), name=tag,
                dataset_overrides=ini.tag_overrides("wl_dataset", tag),
                use_non_linear=ini.bool("wl_use_non_linear", True), **dev))
            needs_cls = True   # WL needs the full theory stage (P(k,z))
    if ini.bool("use_mpk", False):
        # reference: mpk.f90 MPKLikelihood_Add (mpk_numdatasets/mpk_dataset%d
        # keys) + the WiggleZ four-bin route (wigglez.f90)
        from cosmomc_tpu_torch.likelihoods.mpk import (MPKLikelihood,
                                                       WiggleZLikelihood)
        for i in range(1, ini.int("mpk_numdatasets", 0) + 1):
            path = ini.string(f"mpk_dataset{i}", required=True)
            nonlin = ini.bool(f"mpk_dataset_nonlinear{i}", False)
            if "wigglez" in os.path.basename(path).lower():
                likes.add(WiggleZLikelihood(
                    path, nonlinear=nonlin,
                    use_gigglez=ini.bool("Use_gigglez", nonlin), dtype=dtype,
                    **dev))
            else:
                likes.add(MPKLikelihood(path, nonlinear=nonlin, dtype=dtype,
                                        **dev))
            needs_cls = True   # MPK needs the P(k,z) theory stage
    if ini.bool("use_SZ", False):
        # reference: szcounts.f90 SZLikelihood_Add (use_SZ + 1D/2D +
        # prior_* switches); data files live under the dataset dir
        from cosmomc_tpu_torch.likelihoods.szcounts import (PRIOR_SWITCHES,
                                                            SZCountsLikelihood)
        sz_dir = ini.string("sz_data_dir", required=True)
        priors = {sw: ini.bool(sw, False) for sw in PRIOR_SWITCHES}
        switch = 1 if ini.bool("1D", False) else 2
        likes.add(SZCountsLikelihood(
            sz_dir, switch=switch, priors=priors,
            mass_function="watson" if ini.bool("use_watson", False)
            else "tinker", dtype=dtype, **dev))
        needs_cls = True   # SZ needs P(k) -> sigma(R) + sigma8(z)
    if ini.bool("use_HST", False):
        likes.add(HSTLikelihood.from_ini(ini))
    return likes, needs_cls


def _remat_chunks(ini: IniFile) -> int:
    """K1's gradient checkpoints (`boltzmann_remat_chunks`): 64 by default
    for HMC, as the JAX driver's (driver.py:202-213)."""
    method = ini.string("sampling_method", "1").strip().lower()
    return ini.int("boltzmann_remat_chunks", 64 if method in ("8", "hmc") else 0)


def _bbn_table(ini: IniFile):
    """The BBN table of a CMB or LSS posterior: `bbn_table`, else the JAX
    package's default file under $COSMOMC_DATA."""
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    path = ini.string("bbn_table")
    if not path and os.environ.get("COSMOMC_DATA"):
        path = os.path.join(os.environ["COSMOMC_DATA"], DEFAULT_BBN_TABLE)
    if not path or not os.path.isfile(path):
        raise ValueError(
            "the theta and astro parameterizations need a BBN table: set "
            "bbn_table = <grid file> (or COSMOMC_DATA to the directory of "
            f"{DEFAULT_BBN_TABLE})")
    return load_bbn_table(path)


def build_posterior(ini: IniFile, dtype=None, device=None):
    """Composition root: parameterization + space + likelihoods -> posterior
    (TCosmologyConfig + TSetup wiring). `device` defaults to the ini's
    `device` key, itself "cuda" by default."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.params.parameterizations import (
        AstroParameterization, BackgroundParameterization,
        ThetaParameterization)
    from cosmomc_tpu_torch.pipeline import BackgroundPosterior, CMBPosterior

    device = kernels.entry_device(
        ini.string("device", "cuda") if device is None else device,
        "build_posterior")
    if dtype is None:
        dtype = torch.float64 if ini.bool("use_float64", True) else torch.float32
    likes, needs_cls = build_likelihoods(ini, dtype, device)
    kind = ini.string("parameterization", "theta" if needs_cls else "background")
    if kind == "theta":
        par = ThetaParameterization()
    elif kind == "background":
        par = BackgroundParameterization()
    elif kind == "astro":
        # LSS-only runs (CosmologyParameterizations.f90:416-527): P(k)
        # computed, no C_l stack, no CMB likelihoods
        par = AstroParameterization()
    else:
        raise ValueError(f"unknown parameterization {kind}")
    space = par.default_space(ini)
    # priors on base params
    for p in space.params:
        pr = ini.string(f"prior[{p.name}]")
        if pr:
            m, s = (float(x) for x in pr.split())
            p.prior_mean, p.prior_std = m, s
    if not needs_cls:
        return BackgroundPosterior(par, space, likes, device=device,
                                   dtype=dtype)
    if kind == "background":
        raise ValueError("CMB/LSS likelihoods need parameterization="
                         "theta (or astro for LSS-only)")
    if kind == "astro":
        cmb_likes = [l for l in likes.likes
                     if getattr(l, "required_lmax", lambda: 0)() > 0
                     or l.kind == "CMB"]
        if cmb_likes:
            raise ValueError(
                f"parameterization=astro has no tau/C_l: remove CMB "
                f"likelihoods {[l.name for l in cmb_likes]}")
        return CMBPosterior(par, space, likes, bbn_table=_bbn_table(ini),
                            use_cmb=False, matter_power=True,
                            remat_chunks=_remat_chunks(ini), device=device,
                            dtype=dtype)
    compute_tensors = ini.bool("compute_tensors", False)
    if compute_tensors and "r" not in space:
        rspec = ini.string("param[r]")
        if rspec:
            parts = [float(x) for x in rspec.split()]
            if len(parts) == 1:
                space.add(Param("r", parts[0], parts[0], parts[0],
                                0, 0, "r", Speed.SEMISLOW))
            else:
                space.add(Param("r", *parts[:5], label="r",
                                speed=Speed.SEMISLOW))
    # reference key semantics (CosmologyTypes.f90:41-42,197,302): `lmax` is
    # the full output range (raised by the likelihoods' requirements);
    # `lmax_computed_cl` caps the Boltzmann compute, and (lmax_computed_cl,
    # lmax] is filled from the fiducial lensed template
    # `highL_theory_cl_template` (Calculator_CAMB.f90:387-401,890)
    lmax_computed = ini.int("lmax_computed_cl", 0)   # 0 = compute all
    tmpl = ini.string("highL_theory_cl_template", "")
    if lmax_computed and not tmpl and os.environ.get("COSMOMC_DATA"):
        cand = os.path.join(os.environ["COSMOMC_DATA"], "HighL_lensedCls.dat")
        tmpl = cand if os.path.isfile(cand) else ""
    remat = _remat_chunks(ini)
    return CMBPosterior(par, space, likes, bbn_table=_bbn_table(ini),
                        remat_chunks=remat,
                        lmax=ini.int("lmax", 2508),
                        lmax_computed=lmax_computed, highl_template=tmpl,
                        matter_power=ini.bool("use_matter_power", False),
                        compute_tensors=compute_tensors, device=device,
                        dtype=dtype)


def _write_stats(ini: IniFile, file_root: str) -> None:
    """The GetDist outputs of a finished run (`write_stats`, default T)."""
    if ini.bool("write_stats", True):
        from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
        try:
            MCSamples.load(file_root, ignore_frac=0.3).write_all(file_root)
        except FileNotFoundError:
            pass


def run_ini(path: str, overrides: Optional[Dict[str, str]] = None,
            device=None) -> int:
    """Run one ini. `device` ("cuda" or "cpu") overrides the ini's `device`
    key."""
    from cosmomc_tpu_torch.sampling.importance import CMB_BATCH

    t_start = time.time()
    ini = IniFile(path)
    if overrides:
        ini.params.update(overrides)
    action = ini.int("action", 0)
    file_root = ini.string("file_root", required=action != 4)
    if file_root:
        os.makedirs(os.path.dirname(os.path.abspath(file_root)), exist_ok=True)
    feedback = ini.int("feedback", 1)
    post = build_posterior(ini, device=device)
    slow_stage = hasattr(post, "stage_slow")
    on = dict(device=post.device, dtype=post.dtype)

    if action == 4:
        # likelihood test gate (GeneralSetup.f90:146-185)
        P = np.array([p.center for p in post.space.varying])
        t0 = time.time()
        with torch.no_grad():
            mll, _ = post.logpost()(torch.as_tensor(P[None], **on))
            mll = float(mll[0])
            dt = time.time() - t0
            # per-likelihood chi2 table (GeneralSetup.f90:165-172 prints
            # each likelihood's chisq = 2*loglike and its tag)
            for lname, val in post.per_likelihood(P).items():
                print(f"  {lname:<28s} chi2 = {2*val:12.4f}")
        print(f"Test -log(Like) = {mll:18.10f}   ({dt:.1f}s)")
        want = ini.float("test_check_compare")
        rc = 0
        if want is not None:
            ok = abs(mll - want) < 0.05
            print(f"test_check_compare = {want:15.6f}  -> "
                  f"{'OK' if ok else 'MISMATCH'}")
            rc = 0 if ok else 1
        if file_root:
            ini.write_read_values(file_root + ".inputparams")
        return rc

    if action == 2:
        _require_gradient(post, "action = 2")
        from cosmomc_tpu_torch.sampling.minimize import (estimate_covariance,
                                                         find_best_fit,
                                                         write_minimum_file)
        best = find_best_fit(post.logpost(), post.space,
                             use_grad=ini.bool("minimize_use_grad", True),
                             **on)
        # the reverse kernels have no second derivative: a posterior with a
        # slow stage takes its Hessian from differences of exact gradients
        var = post.space.varying
        steps = (np.array([HESSIAN_STEP * p.propose_width for p in var])
                 if slow_stage else None)
        best.cov = estimate_covariance(
            post.logpost(), best.P, gradient_differences=steps,
            bounds=([p.min for p in var], [p.max for p in var]), **on)
        write_minimum_file(file_root + ".minimum", post.space, best)
        post.space.write_covmat(file_root + ".hessian.covmat", best.cov)
        print(f"best fit -logL = {best.mloglike:.6f} "
              f"({best.n_evals} evals, {time.time()-t_start:.1f}s)")
        ini.write_read_values(file_root + ".inputparams")
        return 0

    if action == 1:
        from cosmomc_tpu_torch.sampling.importance import importance_sample_chains
        redo_root = ini.string("redo_root", required=True)
        post_tag = ini.string("post_suffix", "post")
        res = importance_sample_chains(
            redo_root, post.logpost(), f"{file_root}_{post_tag}",
            mode="add" if ini.bool("redo_add", False) else "replace",
            batch=CMB_BATCH if slow_stage else 8192, **on)
        print(f"importance sampling done: eff frac = {res.eff_frac:.3f}")
        return 0

    # ---- action = 0: sampling ----
    from cosmomc_tpu_torch.sampling.metropolis import MetropolisSampler
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
    nchains = ini.int("num_chains", 128)
    # sampling_method (settings.f90:75-79): 1 = metropolis (default; the
    # staged fast/slow variant when the posterior supports it), 8 = HMC
    # ('hmc' also accepted)
    method = ini.string("sampling_method", "1").strip().lower()
    if method in ("8", "hmc"):
        _require_gradient(post, "sampling_method = hmc")
        from cosmomc_tpu_torch.sampling.hmc import HMCRun, HMCSampler
        seed = ini.int("seed", 0)
        sampler = HMCSampler(post.logpost(),
                             num_leapfrog=ini.int("hmc_leapfrog_steps", 16),
                             num_derived=post.num_derived, seed=seed, **on)
        rng = np.random.default_rng(seed)
        # the initial diagonal mass from the proposal widths (the JAX driver
        # starts from the identity, and warmup then adapts the step size to
        # the narrowest parameter and leaves the widest unmoved)
        widths = np.array([p.propose_width for p in post.space.varying])
        run = HMCRun(sampler, nchains, post.start_positions(rng, nchains),
                     seed=seed, inv_mass0=widths ** 2,
                     warmup_segments=ini.int("hmc_warmup_segments", 8),
                     segment_steps=ini.int("segment_steps", 32),
                     max_steps=ini.int("samples", 100_000),
                     r_stop=ini.float("MPI_R_Stop", 0.05),
                     step_size0=ini.float("hmc_step_size", 0.05),
                     chain_root=file_root, feedback=feedback,
                     paramnames=post.paramnames(), space=post.space)
        ini.write_read_values(file_root + ".inputparams")
        res = run.run()
        print(f"done: {res.steps} steps, R-1 = {res.r_minus_1:.4f}, "
              f"accept = {res.accept_rate:.3f}, stopped on {res.stopped_on}")
        _write_stats(ini, file_root)
        return 0
    staged = slow_stage and ini.bool("use_fast_slow", True)
    # staged runs default to oversample_fast=4: fast nuisance proposals are
    # nearly free against the cached theory (propose.f90:261-272)
    prop = post.make_proposal(
        oversample_fast=ini.int("oversample_fast", 4 if staged else 1),
        propose_scale=ini.float("propose_scale", 2.4))
    pm = ini.string("propose_matrix")
    if pm:
        cov, _ = post.space.load_covmat(pm)
        prop.set_covariance(cov)
    else:
        w = np.array([p.propose_width for p in post.space.varying])
        prop.set_covariance(np.diag(w ** 2))
    if staged:
        # the staged sampler reuses cached transfers on semi-slow and fast
        # steps (CalcLike_Cosmology.f90:59-94)
        from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler
        sampler = StagedMetropolisSampler(
            prop, post, temperature=ini.float("temperature", 1.0))
    else:
        sampler = MetropolisSampler(prop, post.logpost(),
                                    num_derived=post.num_derived,
                                    temperature=ini.float("temperature", 1.0),
                                    **on)
    cfg = RunConfig(
        nchains=nchains,
        segment_steps=ini.int("segment_steps", 128),
        max_steps=ini.int("samples", 4_000_000),
        r_stop=ini.float("MPI_R_Stop", 0.05),
        max_r_propose_update=ini.float("MPI_Max_R_ProposeUpdate", 2.0),
        seed=ini.int("seed", 0),
        num_devices=ini.int("num_devices", 0),
        # confidence-limit convergence (SampleCollector.f90:477-544)
        limits_tol=(ini.float("MPI_Limit_Converge_Err", 0.2)
                    if ini.bool("MPI_Check_Limit_Converge", False) else 0.0),
        limit_frac=ini.float("MPI_Limit_Converge", 0.025),
        # error-point policy (reference settings.f90:93)
        stop_on_error=ini.bool("stop_on_error", False),
    )
    rng = np.random.default_rng(cfg.seed)
    run = SamplingRun(sampler, cfg, post.start_positions(rng, nchains),
                      chain_root=file_root, feedback=feedback,
                      paramnames=post.paramnames(), space=post.space)
    if ini.bool("checkpoint", True):
        run.resume()
    ini.write_read_values(file_root + ".inputparams")
    res = run.run()
    print(f"done: {res.steps} steps, R-1 = {res.r_minus_1:.4f}, "
          f"accept = {res.accept_rate:.3f}, stopped on {res.stopped_on}")
    _write_stats(ini, file_root)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(__doc__)
        return 2
    over = {}
    for kv in argv[1:]:
        if "=" in kv:
            k, v = kv.split("=", 1)
            over[k.strip()] = v.strip()
    return run_ini(argv[0], over)


if __name__ == "__main__":
    raise SystemExit(main())
