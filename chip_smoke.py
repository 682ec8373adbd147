#!/usr/bin/env python3
"""Run the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 1 builds the seven hand-written kernels (csrc/, nvcc, sm_90a), one
nvcc process per source, all started together.
Phase 2 holds each kernel against its plain PyTorch version at the main
paths' shapes, in float32 and float64, times both, and computes each
kernel's bound from shape-based counts (OPS): the larger of its operations
over the card's peak rate for their type and its bytes over the memory
rate. K4, K1 and K5 are also timed on one chain or lane: what one
dependency chain costs, however many run beside it.
Phase 3 runs the flagship path at full width in float32 (table LOS engine,
halofit lensing): C_l at the best fit, a plik_lite fiducial written from
them, then CMBPosterior (plik_lite + tau prior, synthetic BBN table) under
StagedMetropolisSampler: init on 8 chains and one 16-step segment with one
slow step.
Phase 4 runs the LCDM+r path the same way (compute_tensors=True, r
semi-slow, recurrence LOS engine, halofit lensing), its fiducial written at
the best fit with r = 0.1, and checks the tensor-only spectrum there.
Phase 5 runs the flagship at phase 3's width under SamplingRun, the run
loop users call: plik_lite + a synthetic DR12-shaped BAO set written from
the port's theory at the best fit + the tau prior, 8 chains, four 16-step
segments from the runner's own schedules, chain files and checkpoints;
then a second run resumes from the checkpoint and must restore the state,
the caches and the generator bit for bit and take the same next segment.
Phase 6 samples the background configuration (BAO + SN + H0 on synthetic
DR12, 6dF and 1048-SN Pantheon-format sets) with MetropolisSampler under
SamplingRun, 256 chains, until R-1 < 0.01.
Phase 2 also holds K1 on the matter grid (216 k to 8/Mpc, one chain) to
its plain version and float32 to float64 at the 6144 steps of the matter
transfers (sigma8, f sigma8 within 0.5%).
Phase 7 runs the flagship with matter power (K1 twice a slow step):
sigma8 and f sigma8 at the best fit against CAMB, and one staged segment
with plik_lite + a DR12 set with f_sigma8 rows + the tau prior.
Phase 8 runs the astro LSS-only configuration (use_cmb=False: K4 and K1
only) with synthetic LRG DR4-format, WiggleZ-format and DR12 f_sigma8 sets
under SamplingRun, 32 chains, then resumes it bit for bit.
Phase 2 also holds K1's extended instantiations, the massive-neutrino
hierarchy and the dark-energy fluid (with a CDM-isocurvature chain), to
the plain version in float64, on the source grid and (massive nu) on the
matter grid.
Phase 9 runs Planck 2018's base_mnu on the flagship (mnu free, matter
power; K1's massive-neutrino instantiation twice a slow step): float32
against float64, plik_lite + a DR12 set with f_sigma8 rows + the tau prior,
one staged segment, and sigma8 at mnu = 0.07 eV against CAMB.
Phase 10 runs base_w_wa the same way (w and wa free; the DE-fluid
instantiation), then the CDM-isocurvature response at four alpha1 values
in float64: C_l quadratic in the admixture amplitude.
Phase 11 runs the SPT configuration on the flagship: SPTpol TE/EE and BB
and an SPT-SZ-shaped CMBLike2 TT set (written from the port's float64
theory at the best fit) raise lmax to 8001, the Boltzmann C_l stop at
2508 and a high-l template written from phase 3's float64 lensed
spectrum fills above. K2a and K3 must run at the flagship's shapes, the
spliced C_l equal the scaled template, -logL at the best fit its
constant (the SPTpol sets' half ln det Cov plus the tau prior); then a
few staged segments, and BK-Planck and CMBLikes HL and fullsky-exact on
the cached theory, float32 against float64.
Phase 12 runs the LSS-only configuration with a BBN prior (the astro
parameterization, K4 and K1 only): DES 1YR-shaped 3x2pt, Planck
2015-shaped SZ cluster counts, D/H and Yp abundances on a written BBN
grid and DR12 BAO with f_sigma8, float32 theory and float64 likelihoods,
32 chains, two staged segments; then the action=4 per-likelihood table on
phase 3's flagship posterior.

It fails (non-zero exit, no result line) when there is no CUDA device,
when the port is not importable, when a kernel does not build, launch or
agree, or when a phase's output is wrong. The last line of standard output
is {"ok": true, "device": {...}}; the line before it lists the kernels.
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import re
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020,
               tau=0.05430138, logA=3.0447260, ns=0.9658923, r=0.1)
NCHAINS = 8
SEG_STEPS = 16
K1_CMP_STEPS = 2048      # K1 and K5 are held to their plain versions here
#: phase 6 (the background configuration): chains (the JAX recipe's
#: >= 256), SNe (Pantheon's count), segment length, and a step budget that
#: keeps the phase near a minute on an H100 (it converged after 2816 steps,
#: in 28-32 s, on an NVIDIA H100 80GB HBM3 at 700 W)
BG_NCHAINS, BG_NSN, BG_SEG_STEPS, BG_MAX_STEPS = 256, 1048, 64, 150 * 64
#: phase 8 (the astro configuration): chains and 16-step segments
ASTRO_NCHAINS, ASTRO_SEGMENTS = 32, 4
MUK2 = 2.7255e6 ** 2
F32, F64 = torch.float32, torch.float64
#: CAMB at the Planck 2018 best fit, with tests/test_matterpower.py's 2.5%
#: tolerance (:22-26, :40-51): sigma8(0), and f sigma8 at the DR12 redshifts
CAMB_SIGMA8, CAMB_TOL = 0.8119545, 0.025
CAMB_FSIGMA8 = {0.38: 0.4779339, 0.51: 0.4760216, 0.61: 0.4706936}
#: float32 sigma8(z) and f sigma8(z) against float64, at the full 6144 steps
SIGMA8_F32_TOL = 5e-3
#: CMBPosterior's default matter-power redshifts
Z_PK = (0.0, 0.2, 0.38, 0.51, 0.61, 1.0, 2.0)
#: phases 9 and 10: the extension parameters as users free them (ini
#: overrides): mnu as the repo's grid (cosmomc_tpu/grid/gridconfig.py:16),
#: w as tests/test_grid.py:25, wa over Planck 2018's w0-wa prior range,
#: alpha1 as the reference (cosmomc_tpu/params/parameterizations.py:177)
EXT_FREE = {"mnu": {"mnu": "0.06 0 5 0.1 0.03"},
            "w0wa": {"w": "-1 -3 1 0.1 0.05", "wa": "0 -3 2 0.1 0.05"}}
ALPHA1_FREE = "0 -0.3 0.3 0.01 0.01"
#: each path's point beside BESTFIT, off the LCDM values (w0, wa crosses
#: w = -1)
EXT_POINT = {"mnu": {"mnu": 0.1}, "w0wa": {"w": -0.9, "wa": -0.3}}
#: CAMB at mnu = 0.07 eV (tests/test_extended_oracle.py:97-117, H0 67.5,
#: ombh2 0.022, omch2 0.122, A_s 2e-9, n_s 0.965, tau 0.06): sigma8(z)
CAMB_SIGMA8_MNU, CAMB_MNU_TOL = {0.0: 0.80044, 3.1: 0.24686}, 0.015
#: the CDM-isocurvature amplitude b of phase 10 (C_l at 0, +-b, 2b) and
#: tests/test_isocurvature.py's tolerance on the quadratic response
ISO_B, ISO_RTOL, ISO_ATOL = 0.2, 5e-4, 1e-6
#: K1's extended instantiations are held to the plain float64 version
#: alone; their float32 output within this share of each plane's maximum
K1_VARIANT_F32_FLOOR = 1e-3
#: step counts tried in turn for holding K1 to its plain version on the
#: matter grid: the first at which every lane of the float32 and float64
#: kernels stays finite and bounded. An unstable RK4 lane grows without
#: bound (the plain version in float64 on the CPU, 2048 steps: the k =
#: 8/Mpc lane reaches |delta_m| ~ 3e17, where 3072 steps keep every lane
#: below ~1e5); `MATTER_BOUNDED` bounds |delta_m| before the curvature
#: normalisation
MATTER_CMP_STEPS = (K1_CMP_STEPS, 3072, 4096, 6144)
MATTER_BOUNDED = 1e8

#: phase 11 (the SPT configuration): the Boltzmann C_l stop at the
#: flagship's lmax and the template fills above, to the lmax the SPTpol
#: TE/EE set asks for (8000 + 1 for its l-derivative); the segments the
#: staged sampler runs; the bound on float32-theory minus float64-theory
#: -logL (each set written at the float64 theory without scatter, so both
#: are near their constant) and on the spliced C_l against norm x template
#: (float32 rounding)
SPT_LMAX_COMPUTED, SPT_LMAX, SPT_SEGMENTS = 2508, 8001, 3
SPT_F32_TOL, SPLICE_RTOL = 1.0, 1e-6
#: K2a's (sampled l, fine k) and K3's lensed width on the flagship
FLAGSHIP_K2A_SHAPE, FLAGSHIP_LENSED_L = (109, 4521), 2507

#: phase 12 (the LSS-only configuration with a BBN prior): chains,
#: segments of SEG_STEPS with one slow step each, the bound on
#: float32-theory minus float64-theory -logL of each likelihood, and the
#: float64 checks at the centres (WL's chi^2/2 at the theory its set was
#: written from; the abundances and SZ against their sums by hand)
LSS_NCHAINS, LSS_SEGMENTS, LSS_F32_TOL = 32, 2, 1.0
LSS_WL_ZERO, LSS_HAND_RTOL = 1e-6, 1e-9

#: phase 13 (the ini driver): the flagship's action 0 (NCHAINS chains,
#: SEG_STEPS-step segments) runs DRIVER_SEGMENTS segments; the HMC run on
#: the background ini (chains, warmup segments, segment steps, sampled
#: steps, leapfrog steps); the CLI's -logL against the posterior built by
#: hand; and the grid's job (chains, steps: enough for RunConfig's 50
#: accepts a block before rows are written) with its HST importance rerun
DRIVER_SEGMENTS = 4
DRIVER_HMC = dict(num_chains=64, hmc_warmup_segments=4, segment_steps=8,
                  samples=64, hmc_leapfrog_steps=8)
DRIVER_MLL_RTOL = 1e-9
DRIVER_GRID = dict(num_chains=64, segment_steps=64, samples=512)

KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "recfast": ("cosmomc_tpu_torch/csrc/recfast.cu",
                "cosmomc_tpu/models/recfast.py:279"),
    "boltzmann": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                  "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_nu": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                     "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_de": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                     "cosmomc_tpu/models/perturbations.py:928"),
    "boltzmann_nu_de": ("cosmomc_tpu_torch/csrc/perturbations.cu",
                        "cosmomc_tpu/models/perturbations.py:928"),
    "los": ("cosmomc_tpu_torch/csrc/cls.cu", "cosmomc_tpu/models/cls.py:285"),
    "lensing": ("cosmomc_tpu_torch/csrc/lensing.cu",
                "cosmomc_tpu/models/lensing.py:136"),
    "los_rec": ("cosmomc_tpu_torch/csrc/los_recurrence.cu",
                "cosmomc_tpu/models/cls.py:473"),
    "tensors": ("cosmomc_tpu_torch/csrc/tensors.cu",
                "cosmomc_tpu/models/tensors.py:254"),
    "tensor_los": ("cosmomc_tpu_torch/csrc/tensor_los.cu",
                   "cosmomc_tpu/models/tensors.py:352"),
}
#: the kernels each main path must launch (phase 5 "runner" is the
#: flagship under SamplingRun; phase 6 "background" launches none; phase 7
#: "flagship_mp" is the flagship with matter power, K1 twice a slow step;
#: phase 8 "astro" the LSS-only configuration; phases 9 "mnu" and 10
#: "w0wa" K1's extended instantiations, twice a slow step; phase 11 "spt"
#: the flagship's kernels at the flagship's shapes under lmax 8001; phase
#: 12 "lss_bbn" the astro configuration with DES, SZ, BBN and BAO; phase
#: 13 "driver" action 0 of `python -m cosmomc_tpu_torch` on the flagship
#: ini; K1's fourth instantiation, boltzmann_nu_de, is on no path: phase 2
#: holds it to its plain version)
PATH_KERNELS = {"flagship": ("recfast", "boltzmann", "los", "lensing"),
                "lcdm_r": ("recfast", "boltzmann", "los_rec", "lensing",
                           "tensors", "tensor_los"),
                "runner": ("recfast", "boltzmann", "los", "lensing"),
                "background": (),
                "flagship_mp": ("recfast", "boltzmann", "los", "lensing"),
                "astro": ("recfast", "boltzmann"),
                "mnu": ("recfast", "boltzmann_nu", "los", "lensing"),
                "w0wa": ("recfast", "boltzmann_de", "los", "lensing"),
                "spt": ("recfast", "boltzmann", "los", "lensing"),
                "lss_bbn": ("recfast", "boltzmann"),
                "driver": ("recfast", "boltzmann", "los", "lensing")}

#: NVIDIA H100 SXM data sheet: dense rates outside the tensor cores, the
#: FP64 tensor cores' rate, and the memory rate
PEAK_OPS = {"fp32": 67e12, "fp64": 34e12, "fp64_tensor": 67e12}
MEM_BYTES_PER_S = 3.35e12
#: operations per unit of work, counted from each kernel's plain version
#: unless said otherwise (a multiply-add counts as two, a divide, square
#: root, exp, log or pow as one):
OPS = {
    # per (chain, z step) from the first live node on (before it the state
    # is the table's): T_M step and 2 Newton iterations ~40, four rate
    # sets (pow, sqrt, exp) ~100, 3 + 3 Newton residuals of x_He, x_H ~140,
    # regime selection ~20 (models/recfast.py:_scan_plain)
    "recfast": 300,
    # per (chain, k, step): an RHS of ~285 (the non-frozen branch; frozen
    # lanes compute it and discard it), and 37 variables x 16 for the RK4
    # combinations + ~50 for the sources (models/perturbations.py:_rhs).
    # The plain version evaluates 5 RHS a step; the least arithmetic is 4
    # where a step's first table row repeats the previous step's last (the
    # fifth evaluation is then the next step's first), which phase 2 counts
    # from the table it runs
    "boltzmann": (285, 37 * 16 + 50),
    # the extended instantiations add to that, per RHS: massive nu, the
    # three node sums 32 (3, 2 and 3 a node), the switch and the three
    # stress terms 12, the 28 Psi derivatives 6 each and the l = 0, 2
    # sources 24 = 236; per step 28 more variables x 16 and the stress
    # derivative for the sources 32. DE fluid, per RHS: 2 stress terms 4
    # and the two derivatives 16 = 20; per step 2 variables x 16
    "boltzmann_nu": (285 + 236, (37 + 28) * 16 + 50 + 32),
    "boltzmann_de": (285 + 20, (37 + 2) * 16 + 50),
    # both extensions: the two sums
    "boltzmann_nu_de": (285 + 236 + 20, (37 + 28 + 2) * 16 + 50 + 32),
    # the least arithmetic that computes the function (csrc/cls.cu, where
    # j'' is folded into the j and j' coefficients): per (chain, l, k, tau)
    # point two lerps 6 and five multiply-adds 10; per (chain, k, tau) the
    # 4 x 4-point interpolation 28, the weights 4, x, index, fraction, 1 - f
    # 4, 1/x, 1/x^2 2, the folded coefficients 5
    "los": (16, 43),
    # the least arithmetic that computes the function (models/cls.py:
    # _los_rec_plain, counted on the data phase 2 runs): per (chain, k,
    # tau, l) point on the live lattice (x above the Airy cut) the
    # recurrence 3: past a node's first dead l its j_l are 0 and need no
    # work, so the cut's compare and select are not counted; per point below
    # L0 (where x*x < l+1 can hold above the cut) the series term 3, its
    # polynomial 5 and its select 2; per (node, sampled l) where j_l or
    # j_{l-1} is nonzero the three sums 12 (regrouped onto four per-node
    # coefficients); per (chain, k, tau) node the 4 x 4-point interpolation
    # 28, the weights 4, x, 1/x, sin, cos, j_0, j_1 and the coefficients 18,
    # and the bisection for its first dead l, a compare and a select per
    # halving of l = 2..lmax (counted in phase 2). Two labelled
    # second bounds: `bound_ms_with_cut_selects` counts the compare and
    # select on every live point (5 a point), `bound_ms_whole_lattice` the
    # plain version's 15 on every point
    "los_rec": (3, 10, 12, 50),
    # per RHS evaluation re-read from models/tensors.py:_tensor_rhs (a
    # divide counted as the product csrc/tensors.cu takes): Psi 13 (its six
    # terms 11, the tight-coupling form 1, the select 1), the switches 3,
    # the stress 11, h'' 4, the Dt ladder 121, Dp 64, Dn 85 = 301; on a
    # tight-coupling row (QT_TC) the Dt and Dp ladders are frozen and pi_g
    # is 0 (_tensor_rhs:161, 187-189): Psi 1, the switches 3, the stress 8,
    # h'' 4, Dn 85 = 101; past the freeze (k tau >= 240) h'' 8; per step 45
    # variables x 15 (RK4) + 10 (step, sources). Counted on the table phase
    # 2 runs: 4 evaluations a released step where its first row repeats the
    # row before (5 otherwise), the source evaluation alone where the lane
    # is not released (the RK4 result is discarded)
    "tensors": (301, 101, 8, 45 * 15 + 10),
    # the least arithmetic that computes the function (csrc/tensor_los.cu,
    # where j'' is folded into the j and j' coefficients), counted on the
    # live lattice of the data phase 2 runs (models/tensors.py:tlos_lattice:
    # the points whose four table entries are not all 0): per live (chain,
    # l, k, tau) point two lerps 6, the coefficient of j in E 2 and five
    # multiply-adds 10; per (chain, k, tau) node the two source lerps and
    # weights 8, x, the index and fraction 4, max(x, 1e-8), 1/x, 1/x^2 3,
    # the six folded coefficients 10. A labelled second bound, `bound_ms_whole_lattice`,
    # counts the plain version's 40 on every point of the whole lattice
    "tensor_los": (18, 25),
}


def lensing_ops(C, L, nth, nl_out):
    """FP64 operations of models/lensing.py:_passes_plain, which does the
    chain-independent work once per (theta, l): pass 1 15, pass 2 108 (the
    Legendre and three Jacobi recurrences, 15 Wigner-d's), pass 3 36 per
    output l; and per (chain, theta, l): pass 1 5, pass 2 84 (the exp, the
    X's and the four xi terms), pass 3 8 per output l. Pass 3's per-chain
    product is a contraction over theta, which csrc/lensing.cu runs on the
    FP64 tensor cores."""
    return {"fp64": nth * (L * (15 + 108) + nl_out * 36) + C * nth * L * (5 + 84),
            "fp64_tensor": C * nth * nl_out * 8}


def k5_ops(qt, k):
    """FP32 operations of one K5 solve on the stage table qt (C, S, R, NQT)
    and wavenumbers k, by OPS["tensors"] (the tight-coupling rows, the rows
    past the freeze, the held steps and the repeated rows counted from the
    table)."""
    from cosmomc_tpu_torch.models import tensors as mten
    per_rhs, per_tc, per_frozen, per_step = OPS["tensors"]
    tau = qt[..., mten.QT_TAU]                                # (C, S, R)
    kk = k.to(qt.dtype)
    tc = (qt[..., mten.QT_TC] > 0.5)[..., None]
    rhs = torch.where(kk * tau[..., None] >= mten.RSA_KTAU_T, per_frozen,
                      torch.where(tc, per_tc, per_rhs))
    R = qt.shape[2]
    repeats = torch.zeros(qt.shape[:2], dtype=torch.bool, device=qt.device)
    repeats[:, 1:] = (qt[:, 1:, 0] == qt[:, :-1, -1]).all(-1)
    # a released step: every stage row (rows 3s + 1 twice), the first row
    # unless it repeats, and the source evaluation at the last row
    stages = rhs[:, :, 1:R - 1].sum(2) + rhs[:, :, 1:R - 1:3].sum(2) \
        + torch.where(repeats[..., None], 0, rhs[:, :, 0])
    released = kk * tau[:, :, -1, None] >= mten.RELEASE_KTAU_T
    per = torch.where(released, stages + per_step, 0) + rhs[:, :, -1]
    return int(per.sum())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(ops, moved):
    """The least time the card could take (ms), the larger of the
    operations over the peak rate of their type (`ops`: type -> count; the
    types' times add) and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_mem = moved / MEM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_mem),
                bound_by="operations" if t_ops >= t_mem else "bytes",
                ops={kind: float(n) for kind, n in ops.items()},
                bytes=float(moved))


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def timed(fn, reps=1):
    """Mean milliseconds of `reps` calls, by CUDA events (after the caller's
    warm-up), and the last result."""
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def check_f32(name, k32, p32, r64, floor):
    """float32 kernel vs the float64 plain result on the same inputs: no
    less accurate than the float32 plain version (or within `floor`)."""
    ek, ep = rel_err(k32, r64), rel_err(p32, r64)
    log(f"  {name:10s} f32 kernel err {ek:.3e}  f32 plain err {ep:.3e} "
        f"(vs f64 plain)  |kernel-plain| {abs_err(k32, p32):.3e}")
    require(ek <= max(2.0 * ep, floor), f"{name} float32 accuracy")
    return abs_err(k32, p32)


def check_f64(name, k64, p64):
    e = rel_err(k64, p64)
    log(f"  {name:10s} f64 kernel vs plain rel err {e:.3e} (tol 1e-9)")
    require(e <= 1e-9, f"{name} float64 agreement")


def bestfit_vector(post, point=None):
    """The varying vector at BESTFIT and `point` (centres for the rest)."""
    at = {**BESTFIT, **(point or {})}
    return np.array([at.get(p.name, p.center) for p in post.space.varying])


class plain_version:
    """Within the block, `module.name` (a CUDA wrapper) is its plain twin:
    `module.twin`, by default the name with "plain" for "cuda"."""
    def __init__(self, module, name, twin=None):
        self.module, self.name = module, name
        self.twin = twin or name.replace("cuda", "plain")

    def __enter__(self):
        self.real = getattr(self.module, self.name)
        setattr(self.module, self.name, getattr(self.module, self.twin))

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def start_points(post, rng, dtype, point=None):
    P0 = np.tile(bestfit_vector(post, point), (NCHAINS, 1))
    sig = np.array([p.propose_width for p in post.space.varying])
    P0 += 0.3 * sig * rng.standard_normal(P0.shape)
    lo = np.array([p.min for p in post.space.varying])
    hi = np.array([p.max for p in post.space.varying])
    return torch.as_tensor(np.clip(P0, lo, hi), dtype=dtype, device=post.device)


def k1_ops(qt, nk, name="boltzmann"):
    """FP32 operations of one K1 solve on the stage table qt (C, S, 3, NQ)
    for nk wavenumbers, by OPS[name] (the instantiation): 5 RHS a step, 4
    where the step's first row repeats the row before."""
    per_rhs, per_step = OPS[name]
    repeats = (qt[:, 1:, 0] == qt[:, :-1, 2]).all(-1).sum(-1)
    return int(((5 * qt.shape[1] - repeats) * per_rhs
                + qt.shape[1] * per_step).sum()) * nk


def k1_against_plain(name, q, k, rnu):
    """K1 against its plain version on the float32 stage table q: float64
    (the table upcast; that one plain run is also the float32 reference)
    and float32 (kernel timed over 3 launches, plain once). Returns the
    float32 |kernel - plain| maximum, both times and the float32 inputs and
    kernel output."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    q32, k32, rnu32 = q.float(), k.float(), rnu.float()
    up = (q32.double(), k32.double(), rnu32.double(), mpert.RSA_KTAU)
    o_r = mpert._evolve_plain(*up)
    check_f64(name, mpert._evolve_cuda(*up), o_r)
    mpert._evolve_cuda(q32, k32, rnu32, mpert.RSA_KTAU)
    ms, o_k = timed(lambda: mpert._evolve_cuda(q32, k32, rnu32,
                                               mpert.RSA_KTAU), reps=3)
    plain_ms, o_p = timed(lambda: mpert._evolve_plain(q32, k32, rnu32,
                                                      mpert.RSA_KTAU))
    err = max(check_f32(f"{name}.{n}", o_k[i], o_p[i], o_r[i], 1e-3)
              for i, n in enumerate(mpert.PLANES))
    return err, ms, plain_ms, (q32, k32, rnu32, o_k)


def check_f32_floor(name, k32, r64, floor):
    """float32 kernel vs the float64 plain result on the same inputs,
    within `floor` of the plane's maximum; returns |kernel - plain|."""
    e = rel_err(k32, r64)
    log(f"  {name:14s} f32 kernel err {e:.3e} (vs f64 plain; floor {floor})")
    require(e <= floor, f"{name} float32 accuracy")
    return abs_err(k32, r64)


def k1_variant_against_plain(name, q, k, rnu, sw, iso=None):
    """An extended K1 instantiation (sw = (massive_nu, de_perts)) against
    its plain version on the float32 stage table q: the plain version once,
    in float64 on the float32 inputs upcast (timed), holds the float64
    kernel (1e-9) and the float32 kernel (K1_VARIANT_F32_FLOOR); the
    float32 kernel timed over 3 launches. Returns the float32 |kernel -
    plain| maximum, both times and the float32 inputs and kernel output."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    q32, k32, rnu32 = q.float(), k.float(), rnu.float()
    iso32 = None if iso is None else iso.float()
    iso_u = None if iso is None else iso32.double()
    up = (q32.double(), k32.double(), rnu32.double(), mpert.RSA_KTAU, *sw)
    plain_ms, o_r = timed(lambda: mpert._evolve_plain(*up, iso=iso_u))
    check_f64(name, mpert._evolve_cuda(*up, iso=iso_u), o_r)

    def kern():
        return mpert._evolve_cuda(q32, k32, rnu32, mpert.RSA_KTAU, *sw, iso=iso32)
    kern()
    ms, o_k = timed(kern, reps=3)
    err = max(check_f32_floor(f"{name}.{n}", o_k[i], o_r[i], K1_VARIANT_F32_FLOOR)
              for i, n in enumerate(mpert.PLANES))
    return err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k)


def phase2(dev, results):
    """Each kernel against its plain version at main-path shapes."""
    from cosmomc_tpu_torch.models import cls as mcls
    from cosmomc_tpu_torch.models import lensing as mlens
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models import recfast as mrec
    from cosmomc_tpu_torch.models import tensors as mten
    from cosmomc_tpu_torch.models.background import BG_FIELDS
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.cmb import source_k_grid
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization

    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (NCHAINS, 1))
    for name in ("ombh2", "omch2", "theta", "tau"):
        full[:, space.index(name)] = BESTFIT[name] * (
            1 + 0.002 * rng.standard_normal(NCHAINS))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    tab = synthetic_bbn_table().to(dev, F64)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, tab)

    # ---- K4: recfast, 8 chains x 8000 z steps
    log("K4 recfast: 8 chains x 8000 steps")
    fHe = yhe / (mrec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = mrec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt64 = mrec._z_tables(bg, mrec.z_grid(mrec.N_Z, dev, F64), fHe,
                          Nnow).contiguous()
    # one plain float64 run, on the float32 tables upcast, serves the
    # float64 check and the float32 reference
    zt32, f32 = zt64.float(), fHe.float()
    r64 = mrec._scan_plain(zt32.double(), f32.double())
    for a, b, n in zip(mrec._scan_cuda(zt32.double(), f32.double()), r64,
                       ("xe", "tm")):
        check_f64("recfast." + n, a, b)
    mrec._scan_cuda(zt32, f32)
    ms, k32 = timed(lambda: mrec._scan_cuda(zt32, f32), reps=10)
    plain_ms, p32 = timed(lambda: mrec._scan_plain(zt32, f32))
    err = max(check_f32("recfast." + n, a, b, c, 1e-4)
              for a, b, c, n in zip(k32, p32, r64, ("xe", "tm")))
    C, _, N = zt32.shape
    live = mrec.first_live_node(zt32)
    log(f"  first live node per chain: {live.tolist()} of {N}")
    z1, f1 = zt32[:1].contiguous(), f32[:1].contiguous()
    mrec._scan_cuda(z1, f1)
    serial_ms, _ = timed(lambda: mrec._scan_cuda(z1, f1), reps=10)
    results["recfast"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              serial_ms=serial_ms, **bound(
                                  {"fp32": int((N - live).sum()) * OPS["recfast"]},
                                  nbytes(zt32, f32, *k32)))
    log(f"  recfast kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, one chain "
        f"{serial_ms:.3f} ms (one dependency chain)")

    # ---- K1: Boltzmann, 8 chains x 248 k; compared at n_step=2048 (the
    # plain version launches ~1e3 ops a step; at 1024 steps the top k lanes
    # of the kmax=0.5 grid are past RK4's stability limit in float32)
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    kgrid = source_k_grid(kmax=0.5)
    k = torch.as_tensor(kgrid, dtype=F64, device=dev)
    log(f"K1 boltzmann: 8 chains x {len(kgrid)} k; compare at {K1_CMP_STEPS} steps")
    tf1, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=K1_CMP_STEPS)
    rnu = mpert._r_nu(bg).contiguous()
    err, ms, plain_ms, (q32, k32_, rnu32, o_k) = k1_against_plain(
        "boltzmann", mpert._stage_tables(bg, tf1), k, rnu)
    log(f"  boltzmann@{K1_CMP_STEPS} kernel {ms:.2f} ms, plain {plain_ms:.1f} ms")
    k1_bound = bound({"fp32": k1_ops(q32, k.shape[0])},
                     nbytes(q32, k32_, rnu32, o_k))
    q1l, k1l, r1l = q32[:1].contiguous(), k32_[-1:].contiguous(), rnu32[:1].contiguous()
    mpert._evolve_cuda(q1l, k1l, r1l, mpert.RSA_KTAU)
    serial_ms, _ = timed(lambda: mpert._evolve_cuda(q1l, k1l, r1l, mpert.RSA_KTAU), 3)
    log(f"  boltzmann@{K1_CMP_STEPS} one lane {serial_ms:.2f} ms (one dependency chain)")
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    q = mpert._stage_tables(bg, tf)
    ms_full = {}
    for dt in (F32, F64):
        qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
        mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU)
        ms_full[dt], _ = timed(lambda: mpert._evolve_cuda(qd, kd, rd,
                                                          mpert.RSA_KTAU), 5)
    full_bound = bound({"fp32": k1_ops(q.float(), k.shape[0])}, 0)["bound_ms"]
    log(f"  boltzmann@8192 kernel f32 {ms_full[F32]:.2f} ms (bound "
        f"{full_bound:.3f} ms), f64 {ms_full[F64]:.2f} ms")
    results["boltzmann"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                ms_8192_steps=ms_full[F32],
                                bound_ms_8192_steps=full_bound,
                                serial_ms=serial_ms, **k1_bound)

    # ---- K2a: LOS at 109 l x 4521 k x 2048 tau, from the 8192-step sources
    log("K2a los: 8 chains, lmax 2658, kmax 0.5, tau stride 4")
    po64 = mpert.evolve_perturbations(bg, tf, tau0, k)
    ipk = torch.argmax(tf.vis, -1, keepdim=True)
    chi = tau0 - tf.tau.gather(-1, ipk)[:, 0]
    args = dict(coarse_k=kgrid, lmax=2658, kmax_hint=0.5, tau_stride=4)
    fields = ("tau", "k", "s0", "s1", "s2", "slens", "tau0")
    cast = lambda po, dt: po._replace(**{f: getattr(po, f).to(dt)
                                         for f in fields})
    clt_k64 = mcls.compute_cl_transfers(po64, chi, **args)
    with plain_version(mcls, "_los_cuda", "_los_plan_plain"):
        clt_p64 = mcls.compute_cl_transfers(po64, chi, **args)
    for f in ("dT", "dE", "dP"):
        check_f64("los." + f, getattr(clt_k64, f), getattr(clt_p64, f))
    po32, chi32 = cast(po64, F32), chi.float()
    mcls.compute_cl_transfers(po32, chi32, **args)   # builds the float32 plan
    ms, clt_k = timed(lambda: mcls.compute_cl_transfers(po32, chi32, **args), 3)
    with plain_version(mcls, "_los_cuda", "_los_plan_plain"):
        plain_ms, clt_p = timed(lambda: mcls.compute_cl_transfers(po32, chi32,
                                                                  **args))
        clt_r = mcls.compute_cl_transfers(cast(po32, F64), chi32.double(),
                                          **args)
    err = max(check_f32("los." + f, getattr(clt_k, f), getattr(clt_p, f),
                        getattr(clt_r, f), 1e-4) for f in ("dT", "dE", "dP"))
    C, nl, nkf = clt_k.dT.shape
    nt = len(range(0, po32.tau.shape[-1], args["tau_stride"]))
    nx = mcls._plan(2658, 14200.0, 0.5, 4.0, 256,
                    tuple(np.asarray(kgrid, np.float64).tolist())).jl.shape[1]
    per_pt, per_knode = OPS["los"]
    results["los"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(
        {"fp32": C * nkf * nt * (nl * per_pt + per_knode)},
        4 * (C * 4 * len(kgrid) * nt + 2 * nl * nx + 3 * C * nt + 3 * C * nl * nkf)))
    log(f"  los kernel {ms:.1f} ms, plain {plain_ms:.1f} ms "
        f"(both incl. the wrapper's source striding/weights)")

    # ---- K3: lensing, l = 2..2658, 5315 theta, 8 chains
    log("K3 lensing: 8 chains, lmax 2658 -> 2508, 5315 theta")
    pp = PrimordialParams.make(logA=torch.full((NCHAINS,), 3.0447, dtype=F64,
                                               device=dev),
                               ns=torch.full((NCHAINS,), 0.9659, dtype=F64,
                                             device=dev))
    raw = mcls.cls_from_cl_transfers(clt_k64, pp, lmax=2658)
    st64 = [raw.tt * MUK2, raw.te * MUK2, raw.ee * MUK2, raw.pp]
    out_k64 = mlens.lens_cls(raw.ls, *st64, lmax_lensed=2508)
    with plain_version(mlens, "_passes_cuda", "_passes_grid_plain"):
        out_p64 = mlens.lens_cls(raw.ls, *st64, lmax_lensed=2508)
    for f in ("tt", "te", "ee", "bb"):
        check_f64("lensing." + f, getattr(out_k64, f), getattr(out_p64, f))
    st32 = [x.float() for x in st64]
    mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508)
    ms, out_k = timed(lambda: mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508), 5)
    again = mlens.lens_cls(raw.ls, *st32, lmax_lensed=2508)
    with plain_version(mlens, "_passes_cuda", "_passes_grid_plain"):
        plain_ms, out_p = timed(lambda: mlens.lens_cls(raw.ls, *st32,
                                                       lmax_lensed=2508))
        out_r = mlens.lens_cls(raw.ls, *[x.double() for x in st32],
                               lmax_lensed=2508)
    for f in ("tt", "te", "ee", "bb"):
        require(torch.equal(getattr(out_k, f), getattr(again, f)),
                f"lensing.{f} repeatable bit for bit")
    err = max(check_f32("lensing." + f, getattr(out_k, f), getattr(out_p, f),
                        getattr(out_r, f), 1e-4) for f in ("tt", "te", "ee", "bb"))
    C, L = st32[0].shape
    nth, nl_out = 2 * (L + 1) - 1, 2508 - 1
    results["lensing"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **bound(
        lensing_ops(C, L, nth, nl_out),
        4 * C * 4 * L + 8 * 7 * nth + 4 * C * nl_out * 4))
    log(f"  lensing kernel {ms:.2f} ms, plain {plain_ms:.1f} ms")

    # ---- K2b: recurrence LOS at K2a's shape (8 chains, 109 l x 4521 k x
    # 2048 tau, l walked 2..2658) on the float32 sources of the 8192-step
    # solve; the float64 check runs on those sources upcast, so one plain
    # run serves both checks
    log("K2b los_rec: 8 chains, lmax 2658, kmax 0.5, tau stride 4")

    def rec(po, c):
        return mcls.compute_cl_transfers_recurrence(po, c, **args)
    po_u, chi_u = cast(po32, F64), chi32.double()
    k64 = rec(po_u, chi_u)
    with plain_version(mcls, "_los_rec_cuda"):
        r64 = rec(po_u, chi_u)
    for f in ("dT", "dE", "dP"):
        check_f64("los_rec." + f, getattr(k64, f), getattr(r64, f))
    rec(po32, chi32)
    ms, ck = timed(lambda: rec(po32, chi32), 3)
    again = rec(po32, chi32)
    with plain_version(mcls, "_los_rec_cuda"):
        plain_ms, cp = timed(lambda: rec(po32, chi32))
    for f in ("dT", "dE", "dP"):
        require(torch.equal(getattr(ck, f), getattr(again, f)),
                f"los_rec.{f} repeatable bit for bit")
    err = max(check_f32("los_rec." + f, getattr(ck, f), getattr(cp, f),
                        getattr(r64, f), 1e-4) for f in ("dT", "dE", "dP"))
    C, nl, nkf = ck.dT.shape
    ls_h, kf_h, _, _, _, cut_h = mcls._rec_plan(
        2658, 14200.0, 0.5, 4.0, tuple(np.asarray(kgrid, np.float64).tolist()))
    _, chi_arg, _, _ = mcls._los_inputs(po32, chi32, args["tau_stride"])
    lat = mcls.rec_lattice(chi_arg, torch.as_tensor(kf_h, dtype=F32, device=dev),
                           torch.as_tensor(cut_h, dtype=F32, device=dev),
                           torch.as_tensor(ls_h, device=dev))
    l0 = mcls.rec_l0(2658, F32)
    nodes = C * nkf * nt
    per_live, per_series, per_sample, per_node = OPS["los_rec"]
    per_node += 2 * math.ceil(math.log2(len(cut_h) - 2))   # the bisection
    rest = per_series * nodes * (l0 - 2) + per_sample * lat["sampled"] \
        + per_node * nodes
    moved = 4 * (C * 4 * len(kgrid) * nt + 3 * C * nt + 3 * C * nl * nkf)
    log(f"  los_rec lattice {lat['lattice']}: live {lat['live']} "
        f"({lat['live'] / lat['lattice']:.4f}), walked {lat['walked']} "
        f"({lat['walked'] / lat['lattice']:.4f}); L0 {l0}; "
        f"(node, sampled l) pairs {lat['sampled']}")
    results["los_rec"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, lattice=lat, l0=l0,
        bound_ms_with_cut_selects=bound({"fp32": 5 * lat["live"] + rest},
                                        moved)["bound_ms"],
        bound_ms_whole_lattice=bound({"fp32": lat["lattice"] * 15}, moved)["bound_ms"],
        **bound({"fp32": per_live * lat["live"] + rest}, moved))
    r = results["los_rec"]
    log(f"  los_rec kernel {ms:.1f} ms, plain {plain_ms:.1f} ms; bound "
        f"{r['bound_ms']:.3f} ms ({r['ops']['fp32']:.4e} ops), with the cut's "
        f"selects {r['bound_ms_with_cut_selects']:.3f}, whole lattice "
        f"{r['bound_ms_whole_lattice']:.3f}; the table engine (K2a) at the "
        f"same shape {results['los']['ms']:.1f} ms")

    # ---- K5: tensor RK4, 8 chains x 96 k; held to its plain version on the
    # 2048-step grid (upcast float32 tables for the float64 check), timed at
    # 8192 steps as well (the main path)
    kt = torch.as_tensor(mten.tensor_k_grid(), dtype=F64, device=dev)
    log(f"K5 tensors: 8 chains x {kt.shape[0]} k; compare at {K1_CMP_STEPS} steps")
    q32, kt32 = mten._stage_table(bg, tf1, 1).float(), kt.float()
    q_u, kt_u = q32.double(), kt32.double()
    o64 = mten._evolve_t_cuda(q_u, kt_u, 1, True)
    r64 = mten._evolve_t_plain(q_u, kt_u, 1, True)
    for i, n in enumerate(mten.T_PLANES):
        check_f64("tensors." + n, o64[i], r64[i])
    mten._evolve_t_cuda(q32, kt32, 1, True)
    ms, o_k = timed(lambda: mten._evolve_t_cuda(q32, kt32, 1, True), 3)
    plain_ms, o_p = timed(lambda: mten._evolve_t_plain(q32, kt32, 1, True))
    err = max(check_f32("tensors." + n, o_k[i], o_p[i], r64[i], 1e-4)
              for i, n in enumerate(mten.T_PLANES))
    ms_full = {}
    for dt in (F32, F64):
        qd, kd = mten._stage_table(bg, tf, 1).to(dt), kt.to(dt)
        mten._evolve_t_cuda(qd, kd, 1, True)
        ms_full[dt], _ = timed(lambda: mten._evolve_t_cuda(qd, kd, 1, True), 2)
    log(f"  tensors@{K1_CMP_STEPS} kernel {ms:.2f} ms, plain {plain_ms:.1f} ms; "
        f"@8192 kernel f32 {ms_full[F32]:.1f} ms, f64 {ms_full[F64]:.1f} ms")
    q1l, k1l = q32[:1].contiguous(), kt32[-1:].contiguous()
    mten._evolve_t_cuda(q1l, k1l, 1, True)
    serial_ms, _ = timed(lambda: mten._evolve_t_cuda(q1l, k1l, 1, True), 3)
    log(f"  tensors@{K1_CMP_STEPS} one lane {serial_ms:.2f} ms (one dependency chain)")
    q8192 = mten._stage_table(bg, tf, 1).float()
    results["tensors"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, ms_8192_steps=ms_full[F32],
        bound_ms_8192_steps=bound({"fp32": k5_ops(q8192, kt32)}, 0)["bound_ms"],
        serial_ms=serial_ms, **bound({"fp32": k5_ops(q32, kt32)},
                                     nbytes(q32, kt32, *o_k)))
    log(f"  tensors bound {results['tensors']['bound_ms']:.4f} ms, @8192 "
        f"{results['tensors']['bound_ms_8192_steps']:.4f} ms; tight-coupling "
        f"rows @8192 {float((q8192[..., mten.QT_TC] > 0.5).float().mean()):.4f}")

    # ---- K6: tensor LOS, 8 chains x 65 l x 610 k x 8192 tau, on K5's
    # float32 output of the 8192-step solve; the float64 check runs on those
    # sources upcast
    log("K6 tensor_los: 8 chains, lmax 700, on K5's 8192-step sources")
    tf32 = tf._replace(**{f: getattr(tf, f).float() for f in tf._fields})
    bg32 = type(bg)(**{f: getattr(bg, f).float() for f in BG_FIELDS},
                    num_massive_nu=bg.num_massive_nu)
    to32 = mten.evolve_tensors(bg32, tf32, tau0.float(), kt32)
    to_u = to32._replace(**{f: getattr(to32, f).double()
                            for f in ("tau", "k", "sT", "sP", "tau0")})
    kgrid_t = mten.tensor_k_grid()

    def tlos(to):
        return mten.compute_tensor_transfers(to, coarse_k=kgrid_t)
    c64 = tlos(to_u)
    with plain_version(mten, "_tlos_cuda"):
        r64 = tlos(to_u)
    for f in ("dT", "dE", "dB"):
        check_f64("tensor_los." + f, getattr(c64, f), getattr(r64, f))
    tlos(to32)
    ms, ck = timed(lambda: tlos(to32), 5)
    again = tlos(to32)
    with plain_version(mten, "_tlos_cuda"):
        plain_ms, cp = timed(lambda: tlos(to32))
    for f in ("dT", "dE", "dB"):
        require(torch.equal(getattr(ck, f), getattr(again, f)),
                f"tensor_los.{f} repeatable bit for bit")
    err = max(check_f32("tensor_los." + f, getattr(ck, f), getattr(cp, f),
                        getattr(r64, f), 1e-4) for f in ("dT", "dE", "dB"))
    targs, _ = mten._tlos_inputs(to32, 700, 14700.0, 0.065, 4.0, kgrid_t)
    alone_ms, _ = timed(lambda: mten._tlos_cuda(*targs), 5)
    C, nl, nkf = ck.dT.shape
    N = to32.tau.shape[-1]
    tabs = mten._TLOS_BY_TABLE[id(targs[7])]
    lat = mten.tlos_lattice(targs[5], targs[4], tabs["n0"], nl,
                            targs[7].shape[1], targs[10])
    per_live, per_node = OPS["tensor_los"]
    moved = nbytes(to32.tau, to32.sT, to32.sP, targs[7], targs[8], ck.dT, ck.dE,
                   ck.dB)
    results["tensor_los"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, kernel_alone_ms=alone_ms,
        lattice=lat, bound_ms_whole_lattice=bound(
            {"fp32": 40 * lat["lattice"]}, moved)["bound_ms"],
        **bound({"fp32": per_live * lat["live"] + per_node * C * nkf * N}, moved))
    r = results["tensor_los"]
    log(f"  tensor_los lattice {lat['lattice']}: live {lat['live']} "
        f"({lat['live'] / lat['lattice']:.4f}), walked {lat['walked']} "
        f"({lat['walked'] / lat['lattice']:.4f})")
    log(f"  tensor_los kernel {ms:.3f} ms with the wrapper, {alone_ms:.3f} ms "
        f"alone, plain {plain_ms:.1f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['ops']['fp32']:.4e} ops), whole lattice at 40 a point "
        f"{r['bound_ms_whole_lattice']:.4f} ms")


def phase2_matter(dev, results):
    """K1 on the matter grid (matter_k_grid(): 216 k to 8/Mpc), one chain
    at the best fit: against its plain version at the first bounded step
    count of MATTER_CMP_STEPS, timed and bounded at that count and at the
    6144 steps of compute_matter_transfers, and float32 against float64
    through compute_matter_transfers / matter_power_from_transfers at 6144
    steps (every lane finite; sigma8(z), f sigma8(z) within 0.5%)."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.recfast import compute_thermo
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization

    par = ThetaParameterization()
    space = par.default_space()
    full = np.array([[BESTFIT.get(p.name, p.center) for p in space.params]])
    tab = synthetic_bbn_table()
    kgrid = mpw.matter_k_grid()
    kmax = float(kgrid[-1])

    def inputs(dt):
        P = torch.as_tensor(full, dtype=dt, device=dev)
        bg = par.to_background(P)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, tab.to(dev, dt))
        return (bg, yhe, compute_thermo(bg, yhe),
                zre_from_tau(bg, P[:, space.index("tau")], yhe))
    bg, yhe, th, zre = inputs(F64)
    k = torch.as_tensor(kgrid, dtype=F64, device=dev)
    rnu = mpert._r_nu(bg).contiguous()
    nk = len(kgrid)
    log(f"K1 boltzmann on the matter grid: 1 chain x {nk} k to {kmax:.4g}/Mpc")
    i_dm = mpert.PLANES.index("dm")
    for n in MATTER_CMP_STEPS:
        tf_n, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n, kmax=kmax)
        q = mpert._stage_tables(bg, tf_n)
        big = {}
        for dt in (F32, F64):
            o = mpert._evolve_cuda(q.to(dt), k.to(dt), rnu.to(dt), mpert.RSA_KTAU)
            big[dt] = (float(o[i_dm].abs().max()) if bool(torch.isfinite(o).all())
                       else math.inf)
        log(f"  {n} steps: max |delta_m| (before normalisation) float32 "
            f"{big[F32]:.4g}, float64 {big[F64]:.4g}")
        if max(big.values()) < MATTER_BOUNDED:
            break
    else:
        require(False, "K1 bounded on the matter grid at some step count")
    log(f"  held to its plain version at {n} steps")
    err, ms, plain_ms, (q32, k32, rnu32, o_k) = k1_against_plain(
        "boltzmann.matter", q, k, rnu)
    cmp_bound = bound({"fp32": k1_ops(q32, nk)}, nbytes(q32, k32, rnu32, o_k))
    # at the 6144 steps compute_matter_transfers runs
    tf, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=6144, kmax=kmax)
    q = mpert._stage_tables(bg, tf)
    ms_full = {}
    for dt in (F32, F64):
        qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
        mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU)
        ms_full[dt], out = timed(lambda: mpert._evolve_cuda(qd, kd, rd,
                                                            mpert.RSA_KTAU), 5)
        if dt == F32:
            full_bound = bound({"fp32": k1_ops(qd, nk)}, nbytes(qd, kd, rd, out))
    # float32 against float64 through the matter-power path, 6144 steps
    sig, mem = {}, {}
    for dt in (F32, F64):
        bg_d, yhe_d, th_d, zre_d = inputs(dt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mt = mpw.compute_matter_transfers(bg_d, th_d, zre_d, yhe_d, Z_PK)
        torch.cuda.synchronize()
        mem[dt] = torch.cuda.max_memory_allocated() - base
        for f in ("delta_m_z", "weyl_z", "v_z"):
            require(bool(torch.isfinite(getattr(mt, f)).all()),
                    f"matter grid {f} finite in every lane ({str(dt)[6:]})")
        one = bg_d.H0.new_ones(1)
        pp = PrimordialParams.make(logA=one * BESTFIT["logA"],
                                   ns=one * BESTFIT["ns"])
        mp = mpw.matter_power_from_transfers(bg_d, pp, mt)
        sig[dt] = (mp.sigma8_z[0].double(), mp.fsigma8_z[0].double())
    e8 = float((sig[F32][0] / sig[F64][0] - 1).abs().max())
    efs8 = float((sig[F32][1] / sig[F64][1] - 1).abs().max())
    log(f"  sigma8(z) at z {Z_PK}: float32 "
        + " ".join(f"{v:.6f}" for v in sig[F32][0].tolist()) + "; float64 "
        + " ".join(f"{v:.6f}" for v in sig[F64][0].tolist()))
    log(f"  f sigma8(z): float32 " + " ".join(f"{v:.6f}" for v in sig[F32][1].tolist())
        + "; float64 " + " ".join(f"{v:.6f}" for v in sig[F64][1].tolist()))
    log(f"  float32 vs float64 at 6144 steps: sigma8 max rel {e8:.3e}, "
        f"f sigma8 max rel {efs8:.3e} (tol {SIGMA8_F32_TOL})")
    require(e8 < SIGMA8_F32_TOL and efs8 < SIGMA8_F32_TOL,
            "float32 sigma8 and f sigma8 within 0.5% of float64")
    log(f"  boltzmann.matter@{n} kernel {ms:.2f} ms (bound {cmp_bound['bound_ms']:.4f} ms), "
        f"plain {plain_ms:.1f} ms; @6144 kernel f32 {ms_full[F32]:.2f} ms (bound "
        f"{full_bound['bound_ms']:.4f} ms, {full_bound['bound_by']}), f64 "
        f"{ms_full[F64]:.2f} ms; compute_matter_transfers peak memory a chain "
        f"{mem[F32] / 2**20:.1f} MiB (float32), {mem[F64] / 2**20:.1f} MiB (float64)")
    results["boltzmann"]["matter_grid"] = dict(
        nk=nk, kmax=kmax, compare_steps=n, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=cmp_bound["bound_ms"],
        bound_by=cmp_bound["bound_by"], ms_6144_steps=ms_full[F32],
        ms_6144_steps_f64=ms_full[F64], bound_ms_6144_steps=full_bound["bound_ms"],
        max_memory_allocated_per_chain={"float32": mem[F32], "float64": mem[F64]},
        sigma8_f32_vs_f64=e8, fsigma8_f32_vs_f64=efs8)


class VariantInputs:
    """K1's extended instantiations' inputs on the source grid: 8 chains
    near BESTFIT with mnu 0.06..0.3 eV, w0 -0.8..-1.2 and wa -0.4..0.3
    across them, the stage tables' thermal functions at K1_CMP_STEPS and
    mpert.N_STEP steps, and an isocurvature amplitude of 0.2 on chain 0.
    `inputs(full, n_step, kmax)` builds the same for other points."""

    def __init__(self, dev):
        from cosmomc_tpu_torch.models import perturbations as mpert
        from cosmomc_tpu_torch.models.cmb import source_k_grid
        from cosmomc_tpu_torch.params.parameterizations import \
            ThetaParameterization
        self.dev, self.par = dev, ThetaParameterization()
        self.space = space = self.par.default_space()
        rng = np.random.default_rng(2)
        full = np.tile([p.center for p in space.params], (NCHAINS, 1))
        for name in ("ombh2", "omch2", "theta", "tau"):
            full[:, space.index(name)] = BESTFIT[name] * (
                1 + 0.002 * rng.standard_normal(NCHAINS))
        for name, lo, hi in (("mnu", 0.06, 0.3), ("w", -0.8, -1.2),
                             ("wa", -0.4, 0.3)):
            full[:, space.index(name)] = np.linspace(lo, hi, NCHAINS)
        self.bg, self.tfs = self.inputs(full, (K1_CMP_STEPS, mpert.N_STEP))
        self.k = torch.as_tensor(source_k_grid(kmax=0.5), dtype=F64, device=dev)
        self.rnu = mpert._r_nu(self.bg).contiguous()
        self.b = torch.zeros(NCHAINS, dtype=F64, device=dev)
        self.b[0] = 0.2

    def inputs(self, full, n_step, kmax=0.5):
        from cosmomc_tpu_torch.models import perturbations as mpert
        from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
        from cosmomc_tpu_torch.models.recfast import compute_thermo
        from cosmomc_tpu_torch.models.reionization import zre_from_tau
        P = torch.as_tensor(full, dtype=F64, device=self.dev)
        bg = self.par.to_background(P)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046,
                      synthetic_bbn_table().to(self.dev, F64))
        th = compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, P[:, self.space.index("tau")], yhe)
        return bg, {n: mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n,
                                                kmax=kmax)[0] for n in n_step}


def phase2_nu_de(dev, results, vi=None):
    """K1's fourth instantiation (massive nu and the DE fluid together,
    `boltzmann_nu_de`) against its plain version run once in float64 on
    the float32 inputs upcast, at the width of phase2_variants' other
    instantiations: VariantInputs' NCHAINS chains (mnu 0.06 to 0.3 eV,
    w0 -0.8 to -1.2, wa -0.4 to 0.3; isocurvature 0.2 on chain 0) x the
    248 k of the source grid at K1_CMP_STEPS steps (kernel f64 1e-9, f32
    within K1_VARIANT_F32_FLOOR), timed and bounded there; then the kernel
    alone at 8192 steps."""
    from cosmomc_tpu_torch.models import perturbations as mpert
    vi = vi or VariantInputs(dev)
    sw = (True, True)
    nk = vi.k.shape[0]
    shape = f"{NCHAINS} chains x {nk} k x {K1_CMP_STEPS} steps"
    log(f"K1 boltzmann_nu_de: compare at {shape} (isocurvature b = 0.2 on "
        "chain 0)")
    iso = mpert.iso_inputs(vi.bg, vi.b)
    err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k) = k1_variant_against_plain(
        "boltzmann_nu_de", mpert._stage_tables(vi.bg, vi.tfs[K1_CMP_STEPS], *sw),
        vi.k, vi.rnu, sw, iso)
    cmp_bound = bound({"fp32": k1_ops(q32, nk, "boltzmann_nu_de")},
                      nbytes(q32, k32, rnu32, iso32, o_k))
    q = mpert._stage_tables(vi.bg, vi.tfs[mpert.N_STEP], *sw).float()
    mpert._evolve_cuda(q, k32, rnu32, mpert.RSA_KTAU, *sw, iso=iso32)
    ms_full, _ = timed(lambda: mpert._evolve_cuda(q, k32, rnu32, mpert.RSA_KTAU,
                                                  *sw, iso=iso32), 5)
    full_bound = bound({"fp32": k1_ops(q, nk, "boltzmann_nu_de")},
                       0)["bound_ms"]
    log(f"  boltzmann_nu_de@{shape}: kernel {ms:.3f} ms (bound "
        f"{cmp_bound['bound_ms']:.4f} ms), plain (float64) {plain_ms:.1f} ms; "
        f"@{mpert.N_STEP} steps: kernel {ms_full:.3f} ms (bound "
        f"{full_bound:.4f} ms)")
    results["boltzmann_nu_de"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_dtype="float64",
        compare_shape=shape, ms_8192_steps=ms_full,
        bound_ms_8192_steps=full_bound, **cmp_bound)


def phase2_variants(dev, results):
    """K1's extended instantiations on the main paths of phases 9 and 10,
    VariantInputs' 8 chains x 248 k on the source grid (the DE fluid also
    with its isocurvature chain): against the plain version at 2048 steps,
    timed and bounded there, on one lane and at 8192 steps; then the
    massive-neutrino instantiation on the matter grid (one chain at mnu
    0.1 eV) at the first bounded count of MATTER_CMP_STEPS, and both
    instantiations timed there at 6144 steps; then both extensions
    together (phase2_nu_de)."""
    from cosmomc_tpu_torch.models import matterpower as mpw
    from cosmomc_tpu_torch.models import perturbations as mpert

    vi = VariantInputs(dev)
    space, bg, tfs, k, rnu, b = vi.space, vi.bg, vi.tfs, vi.k, vi.rnu, vi.b
    inputs = vi.inputs
    nk = k.shape[0]
    for name, sw, iso in (("boltzmann_nu", (True, False), None),
                          ("boltzmann_de", (False, True), mpert.iso_inputs(bg, b))):
        log(f"K1 {name}: {NCHAINS} chains x {nk} k; compare at {K1_CMP_STEPS} steps"
            + (" (isocurvature b = 0.2 on chain 0)" if iso is not None else ""))
        err, ms, plain_ms, (q32, k32, rnu32, iso32, o_k) = k1_variant_against_plain(
            name, mpert._stage_tables(bg, tfs[K1_CMP_STEPS], *sw), k, rnu, sw, iso)
        cmp_bound = bound({"fp32": k1_ops(q32, nk, name)},
                          nbytes(q32, k32, rnu32, o_k, *([iso32] if iso is not None else [])))
        one = lambda x: None if x is None else x[:1].contiguous()
        q1, k1, r1, i1 = one(q32), k32[-1:].contiguous(), one(rnu32), one(iso32)
        mpert._evolve_cuda(q1, k1, r1, mpert.RSA_KTAU, *sw, iso=i1)
        serial_ms, _ = timed(lambda: mpert._evolve_cuda(q1, k1, r1, mpert.RSA_KTAU,
                                                        *sw, iso=i1), 3)
        q = mpert._stage_tables(bg, tfs[mpert.N_STEP], *sw)
        ms_full = {}
        for dt in (F32, F64):
            qd, kd, rd = q.to(dt), k.to(dt), rnu.to(dt)
            idt = None if iso is None else iso.to(dt)
            mpert._evolve_cuda(qd, kd, rd, mpert.RSA_KTAU, *sw, iso=idt)
            ms_full[dt], _ = timed(lambda: mpert._evolve_cuda(
                qd, kd, rd, mpert.RSA_KTAU, *sw, iso=idt), 5)
        full_bound = bound({"fp32": k1_ops(q.float(), nk, name)}, 0)["bound_ms"]
        log(f"  {name}@{K1_CMP_STEPS} kernel {ms:.3f} ms (bound "
            f"{cmp_bound['bound_ms']:.4f} ms), plain (float64) {plain_ms:.1f} ms, one "
            f"lane {serial_ms:.3f} ms; @8192 kernel f32 {ms_full[F32]:.3f} ms (bound "
            f"{full_bound:.4f} ms), f64 {ms_full[F64]:.3f} ms; base K1 @8192 "
            f"{results['boltzmann']['ms_8192_steps']:.3f} ms")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             plain_dtype="float64", ms_8192_steps=ms_full[F32],
                             ms_8192_steps_f64=ms_full[F64],
                             bound_ms_8192_steps=full_bound, serial_ms=serial_ms,
                             **cmp_bound)

    # the matter grid: one chain at mnu 0.1 eV, w0 -0.9, wa -0.3
    kgrid = mpw.matter_k_grid()
    kmax = float(kgrid[-1])
    one = np.array([[{**BESTFIT, "mnu": 0.1, "w": -0.9, "wa": -0.3}.get(p.name, p.center)
                     for p in space.params]])
    bg1, tfm = inputs(one, MATTER_CMP_STEPS, kmax)
    km = torch.as_tensor(kgrid, dtype=F64, device=dev)
    rnu1 = mpert._r_nu(bg1).contiguous()
    i_dm = mpert.PLANES.index("dm")
    sw = (True, False)
    for n in MATTER_CMP_STEPS:
        q = mpert._stage_tables(bg1, tfm[n], *sw)
        big = {}
        for dt in (F32, F64):
            o = mpert._evolve_cuda(q.to(dt), km.to(dt), rnu1.to(dt), mpert.RSA_KTAU, *sw)
            big[dt] = (float(o[i_dm].abs().max()) if bool(torch.isfinite(o).all())
                       else math.inf)
        log(f"  boltzmann_nu, matter grid, {n} steps: max |delta_m| float32 "
            f"{big[F32]:.4g}, float64 {big[F64]:.4g}")
        if max(big.values()) < MATTER_BOUNDED:
            break
    else:
        require(False, "K1 boltzmann_nu bounded on the matter grid at some step count")
    err, ms, plain_ms, (q32, k32, rnu32, _, o_k) = k1_variant_against_plain(
        "boltzmann_nu.matter", q, km, rnu1, sw)
    mg = dict(nk=len(kgrid), kmax=kmax, compare_steps=n, max_abs_err=err, ms=ms,
              plain_ms=plain_ms, **{f: v for f, v in bound(
                  {"fp32": k1_ops(q32, len(kgrid), "boltzmann_nu")},
                  nbytes(q32, k32, rnu32, o_k)).items() if f.startswith("bound")})
    log(f"  boltzmann_nu.matter@{n} kernel {ms:.3f} ms (bound {mg['bound_ms']:.4f} "
        f"ms), plain (float64) {plain_ms:.1f} ms")
    results["boltzmann_nu"]["matter_grid"] = mg
    for name, sw in (("boltzmann_nu", (True, False)), ("boltzmann_de", (False, True))):
        q = mpert._stage_tables(bg1, tfm[MATTER_CMP_STEPS[-1]], *sw).float()
        k32, r32 = km.float(), rnu1.float()
        mpert._evolve_cuda(q, k32, r32, mpert.RSA_KTAU, *sw)
        ms6, _ = timed(lambda: mpert._evolve_cuda(q, k32, r32, mpert.RSA_KTAU, *sw), 5)
        b6 = bound({"fp32": k1_ops(q, len(kgrid), name)}, 0)["bound_ms"]
        log(f"  {name}, matter grid @{MATTER_CMP_STEPS[-1]}: {ms6:.3f} ms (bound "
            f"{b6:.4f} ms; base K1 {results['boltzmann']['matter_grid']['ms_6144_steps']:.3f} ms)")
        results[name].setdefault("matter_grid", {}).update(
            ms_6144_steps=ms6, bound_ms_6144_steps=b6)
    phase2_nu_de(dev, results, vi)


def write_theory_cl(path, cls):
    """CosmoMC theory_cl columns: L TT TE EE BB PP from a (4, 4, lmax+1)
    stack (l(l+1)C_l/2pi muK^2)."""
    c = cls.double().cpu().numpy()
    ls = np.arange(2, c.shape[-1])
    np.savetxt(path, np.column_stack([ls, c[0, 0, 2:], c[1, 0, 2:], c[1, 1, 2:],
                                      c[2, 2, 2:], c[3, 3, 2:]]))


def tensor_anchors(post, full, slow, dtype):
    """The tensor-only spectrum at the best fit (r = 0.1, nt = -r/8) against
    tests/test_tensors.py's anchors (CAMB r = 0.1): the BB recombination
    bump at 78 <= l <= 98 with 4e-3 < BB < 1.1e-2 muK^2, TT(l=10) in
    (35, 65) muK^2. Returns the tensor-only BB (l = 2..700)."""
    from cosmomc_tpu_torch.models.tensors import tensor_cls_from_transfers
    pp = post._primordial(full)
    tens = tensor_cls_from_transfers(slow["tt_cache"], pp,
                                     lmax=min(700, post.lmax))
    ls = tens.ls.cpu().numpy()
    bb = tens.bb[0].double().cpu().numpy() * MUK2
    tt = tens.tt[0].double().cpu().numpy() * MUK2
    ipk = int(np.argmax(bb[:300 - 2]))
    log(f"  tensor-only ({str(dtype)[6:]}), r={float(pp.r[0]):.3f}: BB peak "
        f"{bb[ipk]:.4e} muK^2 at l={ls[ipk]}, TT(l=10) {tt[ls == 10][0]:.2f} muK^2")
    require(78 <= ls[ipk] <= 98, "tensor BB bump at l 78..98")
    require(4e-3 < bb[ipk] < 1.1e-2, "tensor BB bump height")
    require(35.0 < tt[ls == 10][0] < 65.0, "tensor TT plateau at l=10")
    return torch.as_tensor(bb)


def instrument_stages(post):
    """Wrap post.stage_slow/semi/fast to count their calls and sum their
    wall time (synchronised); returns the two dicts they fill."""
    stage_s = {"slow": 0.0, "semi": 0.0, "fast": 0.0}
    calls = {"slow": 0, "semi": 0, "fast": 0}
    for name in stage_s:
        real = getattr(post, f"stage_{name}")

        def wrapped(*a, _real=real, _name=name):
            torch.cuda.synchronize()
            t0 = time.time()
            out = _real(*a)
            torch.cuda.synchronize()
            stage_s[_name] += time.time() - t0
            calls[_name] += 1
            return out
        setattr(post, f"stage_{name}", wrapped)
    return stage_s, calls


def drive_path(dev, tmp, label, cfg):
    """One main path at full width, float32, 8 chains: C_l at the best fit
    (float32 and float64), a plik_lite fiducial written from the float32
    ones, -logL there, then the sampler: init and one 16-step segment with
    one slow step. Returns the path's launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.params.space import Speed
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    par = ThetaParameterization()
    table = synthetic_bbn_table()
    log(f"path {label}: " + json.dumps(cfg))

    def posterior(likes, dtype):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                            dtype=dtype, **cfg)

    def at_bestfit(post, dtype):
        return torch.as_tensor(bestfit_vector(post)[None], dtype=dtype,
                               device=dev)

    # 1. C_l at the best fit through the port (float32 and float64)
    cls, tensor_bb = {}, {}
    for dt in (F32, F64):
        p0 = posterior(LikelihoodList(), dt)
        full = p0.embed_full(at_bestfit(p0, dt))
        t0 = time.time()
        slow = p0.stage_slow(full)
        cls[dt] = p0.stage_semi(full, slow)["cls"][0]
        if dt == F64:
            fid_theory = p0.assemble_theory(slow, dict(cls=None))
        torch.cuda.synchronize()
        log(f"C_l at best fit ({str(dt)[6:]}) {time.time() - t0:.2f} s")
        if p0.compute_tensors:
            tensor_bb[dt] = tensor_anchors(p0, full, slow, dt)
    # float32 vs float64 through the whole stack, relative to each
    # spectrum's maximum over l <= 2000; with tensors also BB over l <= 700
    # (where the tensor C_l land) and the tensor-only BB
    e = {n: rel_err(cls[F32][i, j, 2:2001], cls[F64][i, j, 2:2001])
         for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1), ("BB", 2, 2),
                         ("PP", 3, 3))}
    if tensor_bb:
        e["BB l<=700"] = rel_err(cls[F32][2, 2, 2:701], cls[F64][2, 2, 2:701])
        e["tensor-only BB"] = rel_err(tensor_bb[F32], tensor_bb[F64])
    log("lensed C_l (l <= 2000) float32 vs float64 at the best fit, max rel "
        "err: " + ", ".join(f"{n} {v:.2e}" for n, v in e.items()))
    require(bool(torch.isfinite(cls[F32]).all()), "finite C_l")
    for n, v in e.items():
        require(v < 1e-2, f"float32 {n} within 1% of float64")
    require(2000.0 < float(cls[F64][0, 0, 220]) < 8000.0, "first peak height")

    # 2. plik_lite fiducial from those C_l
    theory_cl = os.path.join(tmp, f"{label}.theory_cl")
    write_theory_cl(theory_cl, cls[F32])
    ds = write_plik_lite_fiducial(os.path.join(tmp, f"{label}_plik_fid"),
                                  theory_cl)

    # 3. the posterior, float32 (the main path's dtype)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F32))
    post = posterior(likes, F32)
    mll_bf, der_bf = post.logpost()(at_bestfit(post, F32))
    log(f"-logL at the best fit: {float(mll_bf[0]):.6f}")
    require(bool(torch.isfinite(mll_bf).all()), "finite -logL at best fit")
    require(float(mll_bf[0]) < 1.0, "fiducial -logL near 0 at its own point")
    dn = [n for n, _ in post.derived_names]
    log("derived at best fit: " + ", ".join(
        f"{n}={float(der_bf[0, dn.index(n)]):.5g}"
        for n in ("H0", "omegam", "zstar", "rdrag", "age", "yheused")))

    # 4. the sampler: init on 8 chains, one 16-step segment, one slow step
    prop = post.make_proposal(oversample_fast=4)
    w = np.array([p.propose_width for p in post.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    P0 = start_points(post, rng, F32)
    sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                               expensive_blocks=expensive)
    step_classes = sampler.block_class[np.asarray(sched.block)]
    if post.compute_tensors:
        r_block = [i for i, b in enumerate(post.space.speed_blocks())
                   if post.space.varying.index(post.space.get("r")) in b]
        require(post.space.get("r").speed == Speed.SEMISLOW
                and sampler.block_class[r_block[0]] == 1
                and bool((step_classes == 1).any()),
                "r sampled in the semi block, with semi steps in the segment")
    stage_s, calls = instrument_stages(post)

    kernels.reset_launches()
    t0 = time.time()
    state = sampler.init_state(P0)
    torch.cuda.synchronize()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    t0 = time.time()
    state, out = sampler.run_segment(state, sched)
    torch.cuda.synchronize()
    t_seg = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: launches[n] - at_init[n] for n in launches}
    log("launches in the segment alone: " + json.dumps(per_segment))
    log(f"init {t_init:.2f} s, segment {t_seg:.2f} s "
        f"({SEG_STEPS * NCHAINS / t_seg:.2f} chain steps/s)")
    log("stage wall time: " + ", ".join(
        f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("launches in the main-path run: " + json.dumps(launches))
    mll = state.mloglike
    log("-logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll))
    acc = float(out.accept.float().mean())
    log(f"acceptance {acc:.3f}, step classes {step_classes.tolist()}")
    for n in KERNELS:
        if n in PATH_KERNELS[label]:
            require(launches[n] > 0, f"{n} launched on the {label} path")
        else:
            require(launches[n] == 0, f"{n} not launched on the {label} path")
    require(bool(torch.isfinite(mll).all()), "finite -logL")
    require(bool((mll < 1e29).all()), "no chain stuck at LOG_ZERO")
    require(out.P.shape == (SEG_STEPS, NCHAINS, post.space.num_varying),
            "segment output shape")
    require(bool(torch.isfinite(out.derived).all()), "finite derived")
    require(not bool(out.error.any()), "no error points")
    return launches, per_segment, dict(ds=ds, theory=fid_theory, cls=cls[F64],
                                       post=post)


def leaves(x, path="state"):
    """(path, tensor) for every tensor in a cache: tensors, dicts, tuples,
    NamedTuples and dataclasses of them."""
    if torch.is_tensor(x):
        yield path, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from leaves(v, f"{path}.{k}")
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k in x._fields:
            yield from leaves(getattr(x, k), f"{path}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from leaves(getattr(x, f.name), f"{path}.{f.name}")


def flagship_dr12(dev, tmp, fid):
    """Phase 5's synthetic DR12-shaped BAO set, written from the port's
    float64 theory at the best fit (phase 3's `fid["theory"]`); its path
    is also kept as `fid["dr12"]`."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao
    d = os.path.join(tmp, "dr12")
    bao0 = BAOLikelihood(write_dr12_bao(d), device=dev, dtype=F64)
    fid["dr12"] = write_dr12_bao(
        d, bao0.theory_vector(fid["theory"])[0].cpu().numpy())
    return fid["dr12"]


def drive_runner(dev, tmp, fid):
    """Phase 5: the flagship at phase 3's width with plik_lite + synthetic
    DR12-shaped BAO + the tau prior, under SamplingRun: 8 chains, 4
    segments of 16 steps from the runner's own schedules, burn-in after one
    accept a block, chain files, R-1, and a checkpoint every 2 segments.
    Eight chains are far from converged after a few segments (R-1 ~ 60),
    so the proposal is learned whatever R-1 (max_r_propose_update, the
    reference's MPI_Max_R_ProposeUpdate, is a user setting): the learned
    covariance is then pushed into the staged state and checkpointed.
    A second run resumes from the checkpoint: its state, caches,
    covariance and generator must equal the first run's bit for bit, and
    one more segment on the same schedule must take the same steps in
    both. Returns the launch counts of the run and per segment."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.io.chains import load_chains
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    sync = torch.cuda.synchronize
    dr12 = flagship_dr12(dev, tmp, fid)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(fid["ds"], name="plik_lite", device=dev,
                                 dtype=F32))
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    par = ThetaParameterization()
    space = par.default_space()
    space.get("tau").prior_mean = 0.0544
    space.get("tau").prior_std = 0.0073
    post = CMBPosterior(par, space, likes, bbn_table=synthetic_bbn_table(),
                        device=dev, dtype=F32)
    at_bf = torch.as_tensor(bestfit_vector(post)[None], dtype=F32, device=dev)
    mll_bf, _ = post.logpost()(at_bf)
    log(f"phase 5: -logL at the best fit (plik_lite + DR12-shaped BAO + tau "
        f"prior) {float(mll_bf[0]):.6f}")
    require(float(mll_bf[0]) < 1.0, "fiducial + BAO -logL near 0 at their point")
    w = np.array([p.propose_width for p in post.space.varying])

    def make_sampler(seed):
        prop = post.make_proposal(oversample_fast=4)
        prop.set_covariance(np.diag(w ** 2))
        return StagedMetropolisSampler(prop, post, seed=seed)

    cfg = RunConfig(nchains=NCHAINS, segment_steps=SEG_STEPS,
                    max_steps=4 * SEG_STEPS, burn_accepts_per_block=1,
                    stats_thin=1, r_stop=0.0, max_r_propose_update=np.inf,
                    checkpoint_freq_segments=2, seed=0)
    P0 = start_points(post, np.random.default_rng(0), F64).cpu().numpy()
    root = os.path.join(tmp, "chains", "flagship")
    s1 = make_sampler(0)
    bare, real_segment = [], s1.run_segment

    def timed_segment(*a, **k):
        sync()
        t0 = time.time()
        out = real_segment(*a, **k)
        sync()
        bare.append(time.time() - t0)
        return out
    s1.run_segment = timed_segment

    sync()
    kernels.reset_launches()
    t0 = time.time()
    run1 = SamplingRun(s1, cfg, P0, chain_root=root, feedback=1,
                       paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    res = run1.run()
    sync()
    launches = dict(kernels.launches)
    s1.run_segment = real_segment
    nseg = len(bare)
    per_segment = {n: (launches[n] - at_init[n]) / nseg for n in launches}
    host = res.wall_s - sum(bare)
    log(f"runner: init {t_init:.3f} s; {nseg} segments in {res.wall_s:.3f} s, "
        f"{res.wall_s / nseg:.3f} s a segment under the runner; bare "
        f"run_segment {np.mean(bare):.3f} s a segment (min {min(bare):.3f}, "
        f"max {max(bare):.3f}); host time the runner adds {host:.3f} s, "
        f"{host / nseg:.4f} s a segment ({host / res.wall_s:.1%})")
    log(f"runner: steps {res.steps}, burn-in at {res.burned_in_at}, R-1 "
        f"{res.r_minus_1:.4f}, acceptance {res.accept_rate:.3f}, "
        f"slow/semi/fast steps {run1.class_steps.tolist()}, "
        f"{res.steps * cfg.nchains / res.wall_s:.2f} chain steps/s")
    log("launches in the runner's run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    learned = not np.array_equal(s1.proposal.covariance, np.diag(w ** 2))
    log(f"proposal learned from the chains: {learned}")
    require(learned, "the runner learned the proposal covariance")
    for n in KERNELS:
        if n in PATH_KERNELS["runner"]:
            require(launches[n] > 0, f"{n} launched under the runner")
        else:
            require(launches[n] == 0, f"{n} not launched under the runner")
    mll = run1.state.mloglike
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL under the runner")
    for ext in (".paramnames", ".ranges", ".converge_stat", ".chk.npz"):
        require(os.path.isfile(root + ext), f"runner wrote {ext}")
    require(res.burned_in_at > 0, "burn-in reached")
    chains = load_chains(root, cfg.nchains)
    written = res.steps - res.burned_in_at + cfg.segment_steps
    require(int(chains["weights"].sum()) == written * cfg.nchains,
            "chain weights sum to the written steps x chains")
    require(chains["samples"].shape[1] == post.space.num_varying
            + post.num_derived, "chain file columns")

    check_resume(run1, s1, make_sampler(1), cfg, P0, root)
    return launches, per_segment


def check_resume(run1, s1, s2, cfg, P0, root):
    """A second run with the fresh sampler s2 resumes from run1's
    checkpoint: its state, its caches (rebuilt by state_from_arrays), the
    proposal covariance and the generator must equal run1's bit for bit,
    and one more segment on one schedule must take the same steps in
    both."""
    from cosmomc_tpu_torch.sampling.runner import SamplingRun
    run2 = SamplingRun(s2, cfg, P0, chain_root=root, feedback=0)
    require(run2.resume(), "resume finds the checkpoint")
    run2.writer.close(flush_pending=False)
    a, b = run1.state, run2.state
    for f in ("P", "mloglike", "derived", "num_accept", "mapping"):
        require(torch.equal(getattr(a, f), getattr(b, f)), f"resumed {f}")
    require((run2.steps_done, run2.burned_in_at)
            == (run1.steps_done, run1.burned_in_at), "resumed step counts")
    require(np.array_equal(s2.proposal.covariance, s1.proposal.covariance),
            "resumed proposal covariance")
    require(torch.equal(s2.generator.get_state(), s1.generator.get_state()),
            "resumed generator state")
    carried = dict(leaves((a.slow, a.semi)))
    rebuilt = dict(leaves((b.slow, b.semi)))
    require(carried.keys() == rebuilt.keys(), "rebuilt caches' layout")
    diffs = {k: float((carried[k].double() - rebuilt[k].double()).abs().max())
             if carried[k].numel() else 0.0 for k in carried
             if not torch.equal(carried[k], rebuilt[k])}
    worst = max(diffs.items(), key=lambda kv: kv[1]) if diffs else ("-", 0.0)
    log(f"caches rebuilt by state_from_arrays: {len(carried)} tensors, "
        f"{len(diffs)} differ from the carried ones; largest difference "
        f"{worst[1]:.3e} in {worst[0]}")
    require(not diffs, "rebuilt caches equal the carried ones bit for bit")
    sched = s1.proposal.make_schedule(cfg.segment_steps,
                                      np.random.default_rng(7))
    _, o1 = s1.run_segment(a, sched)
    _, o2 = s2.run_segment(b, sched)
    require(torch.equal(o1.accept, o2.accept) and torch.equal(o1.P, o2.P),
            "the next segment after resume equals the uninterrupted one")
    log("resume: state, caches, covariance and generator restored bit for "
        f"bit; the next segment takes the same {int(o1.accept.sum())} accepts")


def background_sets(dev, tmp):
    """Phase 6's synthetic sets: DR12-shaped BAO, 6dF, a Pantheon-format
    set of BG_NSN SNe with a mag covmat, all written from the port's
    float64 theory at BACKGROUND_TRUTH without scatter, and the HST H0
    that theory gives at zeff = 0.04. Returns their paths and that H0."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood
    from cosmomc_tpu_torch.models import background as bgm
    from cosmomc_tpu_torch.models.theory import compute_background_theory
    from cosmomc_tpu_torch.params.parameterizations import \
        BackgroundParameterization

    par = BackgroundParameterization()
    full = np.array([p.center for p in par.default_space().params])
    for k, v in sd.BACKGROUND_TRUTH.items():
        full[par.names.index(k)] = v
    th = compute_background_theory(par.to_background(
        torch.as_tensor(full[None], dtype=F64, device=dev)))
    t0 = time.time()
    d = os.path.join(tmp, "background")
    tv = BAOLikelihood(sd.write_dr12_bao(d), device=dev).theory_vector(th)
    dr12 = sd.write_dr12_bao(d, tv[0].cpu().numpy())
    tv = BAOLikelihood(sd.write_6df_bao(d), device=dev).theory_vector(th)
    sixdf = sd.write_6df_bao(d, float(tv[0, 0]))
    cols = sd.pantheon_columns(BG_NSN, seed=0)
    mu = SNLikelihood(sd.write_pantheon(d, cols), device=dev)._mu_model(th)
    sn = sd.write_pantheon(d, cols, mu[0].cpu().numpy() + sd.SN_MB_OFFSET,
                           covmats={"mag": sd.sn_covmat(cols["zcmb"])})
    hst_h0 = float(11425.8 / bgm.angular_diameter_distance(th.bf, 0.04)[0])
    log(f"phase 6: synthetic DR12, 6dF, {BG_NSN} SNe (mag covmat) and HST "
        f"(H0 {hst_h0:.4f}) written at {sd.BACKGROUND_TRUTH} in "
        f"{time.time() - t0:.1f} s")
    return dict(dr12=dr12, sixdf=sixdf, sn=sn, hst_h0=hst_h0)


def drive_background(dev, tmp):
    """Phase 6: bench.py:bench_background's posterior (BackgroundParameterization:
    omegam, H0, ombh2 with its BBN prior; synthetic DR12-shaped BAO, 6dF,
    a Pantheon-format set of BG_NSN SNe with a mag covmat, and HST at the
    truth's H0, all written from the port's float64 theory at
    BACKGROUND_TRUTH without scatter), float32, BG_NCHAINS chains under
    MetropolisSampler and SamplingRun until R-1 < 0.01. Returns the run's
    launch counts and the sets (background_sets). Runs on the CPU too
    (`dev` the CPU device)."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.io.chains import load_chains
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood
    from cosmomc_tpu_torch.likelihoods.sn import SNLikelihood
    from cosmomc_tpu_torch.params.parameterizations import \
        BackgroundParameterization
    from cosmomc_tpu_torch.pipeline import BackgroundPosterior
    from cosmomc_tpu_torch.sampling.metropolis import MetropolisSampler
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    par = BackgroundParameterization()
    sets = background_sets(dev, tmp)
    dr12, sixdf, sn, hst_h0 = (sets[k] for k in ("dr12", "sixdf", "sn", "hst_h0"))

    def posterior(dtype):
        likes = LikelihoodList()
        likes.add(BAOLikelihood(dr12, device=dev, dtype=dtype))
        likes.add(BAOLikelihood(sixdf, device=dev, dtype=dtype))
        likes.add(SNLikelihood(sn, device=dev, dtype=dtype))
        likes.add(HSTLikelihood(H0=hst_h0, H0_err=1.66))
        return BackgroundPosterior(par, par.default_space(), likes,
                                   device=dev, dtype=dtype)
    post = posterior(F32)
    names = [p.name for p in post.space.varying]
    require(names == ["omegam", "H0", "ombh2"], "background sampled names")
    nchains = BG_NCHAINS
    start = post.start_positions(np.random.default_rng(0), nchains)
    m32 = post.logpost()(torch.as_tensor(start, dtype=F32, device=dev))[0]
    m64 = posterior(F64).logpost()(torch.as_tensor(start, dtype=F64,
                                                   device=dev))[0]
    dm = (m32.double() - m64).abs()
    log(f"background -logL at the {nchains} start points: float32 - float64 "
        f"max {float(dm.max()):.4f}, rms {float(dm.pow(2).mean().sqrt()):.4f} "
        f"(float64 values {float(m64.min()):.2f}..{float(m64.max()):.2f})")
    prop = post.make_proposal()
    prop.set_covariance(np.diag([p.propose_width ** 2
                                 for p in post.space.varying]))
    sampler = MetropolisSampler(prop, post.logpost(),
                                num_derived=post.num_derived, device=dev,
                                dtype=F32)
    cfg = RunConfig(nchains=nchains, segment_steps=BG_SEG_STEPS,
                    max_steps=BG_MAX_STEPS, r_stop=0.01,
                    burn_accepts_per_block=30, stats_thin=1, seed=1)
    root = os.path.join(tmp, "chains", "background")
    sync()
    kernels.reset_launches()
    t0 = time.time()
    run = SamplingRun(sampler, cfg, start, chain_root=root, feedback=0,
                      paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    res = run.run()
    sync()
    launches = dict(kernels.launches)
    log(f"background: {res.stopped_on} at R-1 = {res.r_minus_1:.5f} after "
        f"{res.steps} steps x {nchains} chains; wall-clock to R-1 < 0.01 "
        f"{res.wall_s:.3f} s (init {t_init:.3f} s more); burn-in at "
        f"{res.burned_in_at}; acceptance {res.accept_rate:.3f}; "
        f"{res.steps * nchains / res.wall_s:.1f} chain steps/s")
    require(not any(launches.values()),
            "the background configuration launches no kernel")
    require(res.stopped_on == "converged", "background R-1 < 0.01")
    chains = load_chains(root, nchains)
    written = res.steps - res.burned_in_at + cfg.segment_steps
    require(bool((chains["weights"] >= 1).all())
            and int(chains["weights"].sum()) == written * nchains,
            "background chain weights sum to the written steps x chains")
    require(chains["samples"].shape[1] == 3 + post.num_derived,
            "background chain file columns")
    sig = np.sqrt(np.diag(res.cov))
    for i, name in enumerate(names):
        pull = (res.means[i] - sd.BACKGROUND_TRUTH[name]) / sig[i]
        log(f"  {name}: pooled mean {res.means[i]:.6g} +- {sig[i]:.4g} "
            f"(truth {sd.BACKGROUND_TRUTH[name]}, {pull:+.2f} sigma)")
        if name in ("omegam", "H0"):
            require(abs(pull) < 3.0, f"{name} within 3 sigma of the truth")
    return launches, sets


def drive_matter_power(dev, tmp, fid):
    """Phase 7: the flagship with matter power (CMBPosterior(matter_power=
    True), full width, float32, 8 chains): the slow stage's time with and
    without matter power, sigma8(0) and f sigma8 at 0.38, 0.51, 0.61 at the
    best fit against CAMB (2.5%), then plik_lite + a synthetic DR12 set with
    f_sigma8 rows (written from the port's float64 theory at the best fit)
    + the tau prior under StagedMetropolisSampler: init and one 16-step
    segment with one slow step, which must launch K4 once, K1 twice and K2a
    once a slow step and K3 once a semi step. Returns the launch counts."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior

    par = ThetaParameterization()
    table = synthetic_bbn_table()
    sync = torch.cuda.synchronize

    def posterior(likes, dtype, matter_power=True):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                            dtype=dtype, matter_power=matter_power)

    def at_bestfit(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post), (n, 1)),
                               dtype=dtype, device=dev)

    # 1. the slow stage with and without matter power, 8 chains, float32
    slow_s, mem = {}, {}
    for on in (False, True):
        post = posterior(LikelihoodList(), F32, on)
        full = post.embed_full(at_bestfit(post, F32, NCHAINS))
        post.stage_slow(full)
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        for _ in range(2):
            post.stage_slow(full)
        sync()
        slow_s[on] = (time.time() - t0) / 2
        mem[on] = (torch.cuda.max_memory_allocated() - base) / NCHAINS
    log(f"phase 7: slow stage, {NCHAINS} chains, float32: {slow_s[False]:.3f} s "
        f"a call without matter power, {slow_s[True]:.3f} s with it; peak "
        f"memory a chain {mem[False] / 2**20:.1f} MiB, "
        f"{mem[True] / 2**20:.1f} MiB")

    # 2. sigma8 and f sigma8 at the best fit against CAMB
    s8 = {}
    for dt in (F32, F64):
        post = posterior(LikelihoodList(), dt)
        full = post.embed_full(at_bestfit(post, dt, NCHAINS if dt == F32 else 1))
        slow = post.stage_slow(full)
        theory = post.assemble_theory(slow, post.stage_semi(full, slow))
        require(bool(torch.isfinite(theory.sigma8_z).all()
                     and torch.isfinite(theory.fsigma8_z).all()),
                f"finite sigma8 tables ({str(dt)[6:]})")
        s8[dt] = [float(theory.sigma8_z[0, 0])] + [
            float(theory.fsigma8_at(z)[0]) for z in CAMB_FSIGMA8]
        if dt == F64:
            theory64 = theory
    ref = [CAMB_SIGMA8] + list(CAMB_FSIGMA8.values())
    names = ["sigma8(0)"] + [f"fsigma8({z})" for z in CAMB_FSIGMA8]
    for dt in (F32, F64):
        log(f"  {str(dt)[6:]}: " + ", ".join(
            f"{n} {v:.6f} ({v / r - 1:+.4%} vs CAMB {r})"
            for n, v, r in zip(names, s8[dt], ref)))
    for v, r, n in zip(s8[F32], ref, names):
        require(abs(v / r - 1) < CAMB_TOL, f"float32 {n} within 2.5% of CAMB")
    require(max(abs(a / b - 1) for a, b in zip(s8[F32], s8[F64]))
            < SIGMA8_F32_TOL, "float32 sigma8 and f sigma8 within 0.5% of float64")

    # 3. plik_lite + DR12 with f_sigma8 rows + tau prior, one staged segment
    d = os.path.join(tmp, "dr12_fs8")
    bao0 = BAOLikelihood(write_dr12_bao(d, fsigma8=True), device=dev, dtype=F64)
    ds = write_dr12_bao(d, bao0.theory_vector(theory64)[0].cpu().numpy(),
                        fsigma8=True)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(fid["ds"], name="plik_lite", device=dev,
                                 dtype=F32))
    likes.add(BAOLikelihood(ds, device=dev, dtype=F32))
    post = posterior(likes, F32)
    mll_bf, der_bf = post.logpost()(at_bestfit(post, F32))
    dn = [n for n, _ in post.derived_names]
    mp_names = ["sigma8", "S8", "fsigma8z038", "fsigma8z051", "fsigma8z061"]
    log(f"  -logL at the best fit (plik_lite + DR12 with f_sigma8 + tau "
        f"prior) {float(mll_bf[0]):.6f}; derived " + ", ".join(
            f"{n}={float(der_bf[0, dn.index(n)]):.6f}" for n in mp_names))
    require(float(mll_bf[0]) < 1.0, "fiducial + f_sigma8 BAO -logL near 0")
    launches, per_segment, out = segment_with_matter_power(post, "flagship_mp")
    idx = [dn.index(n) for n in mp_names]
    require(bool(torch.isfinite(out.derived[..., idx]).all()),
            "sigma8, S8 and fsigma8z* finite in the segment's derived values")
    return launches, per_segment


def segment_with_matter_power(post, label, point=None):
    """Init and one 16-step segment with one slow step under
    StagedMetropolisSampler from start points around the best fit (and
    `point`): the run must launch K4 and K2a once, the path's K1
    (PATH_KERNELS[label][1]) twice a slow step and K3 once a semi step,
    nothing else; finite -logL and derived values, no error points.
    Returns the run's launch counts, the segment's and its output."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler
    sync = torch.cuda.synchronize
    prop = post.make_proposal(oversample_fast=4)
    w = np.array([p.propose_width for p in post.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    P0 = start_points(post, rng, F32, point)
    sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                               expensive_blocks=expensive)
    stage_s, calls = instrument_stages(post)
    kernels.reset_launches()
    t0 = time.time()
    state = sampler.init_state(P0)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    t0 = time.time()
    state, out = sampler.run_segment(state, sched)
    sync()
    t_seg = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: launches[n] - at_init[n] for n in launches}
    log(f"  init {t_init:.2f} s, segment {t_seg:.2f} s "
        f"({SEG_STEPS * NCHAINS / t_seg:.2f} chain steps/s); stage wall time: "
        + ", ".join(f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("  launches in the main-path run: " + json.dumps(launches)
        + "; in the segment alone: " + json.dumps(per_segment))
    want = {"recfast": calls["slow"], PATH_KERNELS[label][1]: 2 * calls["slow"],
            "los": calls["slow"], "lensing": calls["semi"]}
    for n in KERNELS:
        require(launches[n] == want.get(n, 0),
                f"{n} launched {want.get(n, 0)} times on the {label} path")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            f"finite -logL on the {label} path")
    require(bool(torch.isfinite(out.derived).all()), f"{label}: finite derived")
    require(not bool(out.error.any()), f"{label}: no error points")
    return launches, per_segment, out


def drive_astro(dev, tmp):
    """Phase 8: the astro LSS-only configuration (AstroParameterization,
    CMBPosterior(use_cmb=False, matter_power=True), float32): a synthetic
    LRG DR4-format P(k) set (no Q model), a WiggleZ-format bin at z = 0.6
    with the GiggleZ correction and a DR12 set with f_sigma8 rows, each
    written from the port's float64 theory at the parameterization's
    centres; -logL there is the LRG set's 1/2 ln(P C^-1 P) alone.
    ASTRO_NCHAINS chains under SamplingRun, ASTRO_SEGMENTS segments of 16
    steps, a checkpoint every 2, then a resume that must restore the state
    and the caches (matter transfers and P(k, z) tables included) bit for
    bit. Only K4 and K1 may launch. Returns the launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.mpk import MPKLikelihood, WiggleZLikelihood
    from cosmomc_tpu_torch.models import background as bgm
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import AstroParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.runner import RunConfig, SamplingRun
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    par = AstroParameterization()
    table = synthetic_bbn_table()
    sync = torch.cuda.synchronize

    def posterior(likes, dtype):
        return CMBPosterior(par, par.default_space(), likes, bbn_table=table,
                            use_cmb=False, matter_power=True, device=dev,
                            dtype=dtype)
    p64 = posterior(LikelihoodList(), F64)
    truth = np.array([p.center for p in p64.space.varying])
    full = p64.embed_full(torch.as_tensor(truth[None], dtype=F64, device=dev))
    slow = p64.stage_slow(full)
    th = p64.assemble_theory(slow, p64.stage_semi(full, slow))
    dv_fid = lambda z: float(th.bg.H0[0] * bgm.bao_d_v(th.bf, z)[0])
    d = os.path.join(tmp, "astro")
    lrg_layout, lrg_keys = sd.lrg_layout(0), dict(DV_fid=dv_fid(sd.LRG_Z),
                                                   Q_marge="F")
    lrg0 = MPKLikelihood(sd.write_lrg_mpk(d, lrg_layout, settings=lrg_keys),
                         device=dev)
    lrg = sd.write_lrg_mpk(d, lrg_layout, sd.mpk_bandpowers(lrg0, th), lrg_keys)
    wz_layout = sd.wigglez_layout(0)
    wz0 = WiggleZLikelihood(sd.write_wigglez(d, wz_layout, 0.6,
                                             DV_fid=dv_fid(0.6)), device=dev)
    wz = sd.write_wigglez(d, wz_layout, 0.6, sd.mpk_bandpowers(wz0, th),
                          dv_fid(0.6))
    bao0 = BAOLikelihood(sd.write_dr12_bao(d, fsigma8=True), device=dev,
                         dtype=F64)
    dr12 = sd.write_dr12_bao(d, bao0.theory_vector(th)[0].cpu().numpy(),
                             fsigma8=True)
    likes = LikelihoodList()
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    likes.add(MPKLikelihood(lrg, device=dev, dtype=F32))
    likes.add(WiggleZLikelihood(wz, device=dev, dtype=F32))
    post = posterior(likes, F32)
    names = [p.name for p in post.space.varying]
    require(names == ["omegam", "omegab", "H0", "logA", "ns"],
            "astro sampled names")
    lrg_like = likes.likes[1]
    norm = 0.5 * math.log(lrg_like.P_data @ lrg_like.invcov @ lrg_like.P_data)
    mll = float(post.logpost()(torch.as_tensor(truth[None], dtype=F32,
                                               device=dev))[0][0])
    log(f"phase 8: astro -logL at the truth {mll:.6f}; the LRG set's "
        f"1/2 ln(P C^-1 P) {norm:.6f}; sigma8(0) {float(th.sigma8_z[0, 0]):.6f} "
        f"(float64)")
    require(abs(mll - norm) < 1.0, "astro -logL at the truth near its "
            "normalisation alone")

    w = np.array([p.propose_width for p in post.space.varying])

    def make_sampler(seed):
        prop = post.make_proposal()
        prop.set_covariance(np.diag(w ** 2))
        return StagedMetropolisSampler(prop, post, seed=seed)
    cfg = RunConfig(nchains=ASTRO_NCHAINS, segment_steps=SEG_STEPS,
                    max_steps=ASTRO_SEGMENTS * SEG_STEPS,
                    burn_accepts_per_block=1, stats_thin=1, r_stop=0.0,
                    max_r_propose_update=np.inf, checkpoint_freq_segments=2,
                    seed=0)
    lo = np.array([p.min for p in post.space.varying])
    hi = np.array([p.max for p in post.space.varying])
    P0 = np.clip(truth + 0.3 * w * np.random.default_rng(0).standard_normal(
        (ASTRO_NCHAINS, len(w))), lo, hi)
    root = os.path.join(tmp, "chains", "astro")
    s1 = make_sampler(0)
    sync()
    kernels.reset_launches()
    t0 = time.time()
    run1 = SamplingRun(s1, cfg, P0, chain_root=root, feedback=0,
                       paramnames=post.paramnames(), space=post.space)
    sync()
    t_init = time.time() - t0
    at_init = dict(kernels.launches)
    res = run1.run()
    sync()
    launches = dict(kernels.launches)
    per_segment = {n: (launches[n] - at_init[n]) / ASTRO_SEGMENTS
                   for n in launches}
    log(f"astro: init {t_init:.3f} s; {res.steps} steps x {ASTRO_NCHAINS} "
        f"chains in {res.wall_s:.3f} s ({res.wall_s / ASTRO_SEGMENTS:.3f} s a "
        f"segment, {res.steps * ASTRO_NCHAINS / res.wall_s:.1f} chain steps/s); "
        f"burn-in at {res.burned_in_at}; acceptance {res.accept_rate:.3f}; "
        f"slow/semi/fast steps {run1.class_steps.tolist()}")
    log("launches in the astro run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    for n in KERNELS:
        if n in PATH_KERNELS["astro"]:
            require(launches[n] > 0, f"{n} launched on the astro path")
        else:
            require(launches[n] == 0, f"{n} not launched on the astro path")
    mll = run1.state.mloglike
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite astro -logL")
    require(res.steps == cfg.max_steps, "astro ran its segments")
    check_resume(run1, s1, make_sampler(1), cfg, P0, root)
    return launches, per_segment


def ext_posterior(dev, label, likes, dtype, alpha1=False):
    """CMBPosterior of phase 9 or 10 at full width: the flagship's
    parameterization with EXT_FREE[label] (and alpha1) freed by ini
    overrides, the tau prior, matter power."""
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.utils.ini import IniFile
    keys = {f"param[{n}]": v for n, v in EXT_FREE[label].items()}
    if alpha1:
        keys["param[alpha1]"] = ALPHA1_FREE
    par = ThetaParameterization()
    space = par.default_space(IniFile(keys=keys))
    space.get("tau").prior_mean = 0.0544
    space.get("tau").prior_std = 0.0073
    return CMBPosterior(par, space, likes, bbn_table=synthetic_bbn_table(),
                        matter_power=True, device=dev, dtype=dtype)


def drive_extended(dev, tmp, label):
    """Phases 9 ("mnu": Planck 2018's base_mnu) and 10 ("w0wa": base_w_wa):
    the flagship with EXT_FREE[label] sampled and matter power, full width,
    8 chains, at EXT_POINT[label]: the auto switches (the massive-neutrino
    hierarchy or the DE fluid, alone); C_l float32 against float64 (1%),
    sigma8(z) and f sigma8(z) (0.5%); a plik_lite fiducial written from the
    float32 C_l and a DR12 set with f_sigma8 rows from the float64 theory;
    -logL there with the tau prior; then init and one 16-step segment with
    one slow step under StagedMetropolisSampler, which must launch K4, K2a
    once and the path's K1 instantiation twice a slow step and K3 once a
    semi step, nothing else. Returns the launch counts."""
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.forecast import write_plik_lite_fiducial
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.likelihoods.synthetic import write_dr12_bao

    sync = torch.cuda.synchronize
    point = EXT_POINT[label]
    log(f"phase {label}: " + json.dumps(EXT_FREE[label]) + " at "
        + json.dumps(point))

    def at(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post, point), (n, 1)),
                               dtype=dtype, device=dev)

    # 1. the theory at the point, float32 (8 chains) and float64 (1 chain)
    theory, cls = {}, {}
    for dt in (F32, F64):
        p0 = ext_posterior(dev, label, LikelihoodList(), dt)
        want = (label == "mnu", label == "w0wa", False)
        require((p0.massive_nu_hierarchy, p0.de_perturbations, p0._iso_enabled)
                == want, f"{label}: the auto switches {want}")
        require(set(EXT_FREE[label]) <= {p.name for p in p0.space.varying},
                f"{label}: {sorted(EXT_FREE[label])} sampled")
        full = p0.embed_full(at(p0, dt, NCHAINS if dt == F32 else 1))
        t0 = time.time()
        slow = p0.stage_slow(full)
        semi = p0.stage_semi(full, slow)
        sync()
        log(f"  theory at the point ({str(dt)[6:]}, {full.shape[0]} chains) "
            f"{time.time() - t0:.2f} s")
        theory[dt], cls[dt] = p0.assemble_theory(slow, semi), semi["cls"][0]
    e = {n: rel_err(cls[F32][i, j, 2:2001], cls[F64][i, j, 2:2001])
         for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1), ("BB", 2, 2),
                         ("PP", 3, 3))}
    s8 = {dt: (theory[dt].sigma8_z[0].double(), theory[dt].fsigma8_z[0].double())
          for dt in (F32, F64)}
    e8 = float((s8[F32][0] / s8[F64][0] - 1).abs().max())
    efs8 = float((s8[F32][1] / s8[F64][1] - 1).abs().max())
    log("  lensed C_l (l <= 2000) float32 vs float64, max rel err: "
        + ", ".join(f"{n} {v:.2e}" for n, v in e.items())
        + f"; sigma8(z) {e8:.3e}, f sigma8(z) {efs8:.3e}; sigma8(0) float32 "
        f"{float(s8[F32][0][0]):.6f}, float64 {float(s8[F64][0][0]):.6f}")
    require(bool(torch.isfinite(cls[F32]).all()), f"{label}: finite C_l")
    for n, v in e.items():
        require(v < 1e-2, f"{label}: float32 {n} within 1% of float64")
    require(2000.0 < float(cls[F64][0, 0, 220]) < 8000.0, f"{label}: first peak")
    require(e8 < SIGMA8_F32_TOL and efs8 < SIGMA8_F32_TOL,
            f"{label}: float32 sigma8 and f sigma8 within 0.5% of float64")

    # 2. the fiducial sets, 3. -logL at the point
    theory_cl = os.path.join(tmp, f"{label}.theory_cl")
    write_theory_cl(theory_cl, cls[F32])
    ds = write_plik_lite_fiducial(os.path.join(tmp, f"{label}_plik_fid"), theory_cl)
    d = os.path.join(tmp, f"{label}_dr12")
    bao0 = BAOLikelihood(write_dr12_bao(d, fsigma8=True), device=dev, dtype=F64)
    dr12 = write_dr12_bao(d, bao0.theory_vector(theory[F64])[0].cpu().numpy(),
                          fsigma8=True)
    likes = LikelihoodList()
    likes.add(PlikLiteLikelihood(ds, name="plik_lite", device=dev, dtype=F32))
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F32))
    post = ext_posterior(dev, label, likes, F32)
    mll_bf, der_bf = post.logpost()(at(post, F32))
    dn = [n for n, _ in post.derived_names]
    log(f"  -logL at the point (plik_lite + DR12 with f_sigma8 + tau prior) "
        f"{float(mll_bf[0]):.6f}; derived " + ", ".join(
            f"{n}={float(der_bf[0, dn.index(n)]):.6f}"
            for n in ("H0", "omeganuh2", "sigma8", "S8", "fsigma8z051")))
    require(float(mll_bf[0]) < 1.0, f"{label}: fiducial -logL near 0 at its point")
    launches, per_segment, _ = segment_with_matter_power(post, label, point)
    return launches, per_segment


def sigma8_mnu_anchors(dev):
    """Phase 9: sigma8(0) and sigma8(3.1) at mnu = 0.07 eV through
    compute_matter_power with the massive-neutrino hierarchy (K1's
    instantiation on the matter grid, 6144 steps, linear), float32 and
    float64, against CAMB_SIGMA8_MNU (1.5%; tests/test_extended_oracle.py,
    whose YHe comes from the BBN table: here the synthetic one)."""
    from cosmomc_tpu_torch.models.background import BackgroundParams
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn
    from cosmomc_tpu_torch.models.matterpower import compute_matter_power
    from cosmomc_tpu_torch.models.primordial import PrimordialParams
    from cosmomc_tpu_torch.models.recfast import compute_thermo
    from cosmomc_tpu_torch.models.reionization import zre_from_tau
    from cosmomc_tpu_torch.params.parameterizations import mnu_to_omnuh2
    zs = tuple(CAMB_SIGMA8_MNU)
    s8 = {}
    for dt in (F32, F64):
        bg = BackgroundParams.make(ombh2=0.022, omch2=0.122, H0=67.5,
                                   omnuh2=mnu_to_omnuh2(0.07), device=dev, dtype=dt)
        yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, dt))
        th = compute_thermo(bg, yhe)
        zre = zre_from_tau(bg, torch.full((1,), 0.06, dtype=dt, device=dev), yhe)
        one = bg.H0.new_ones(1)
        pp = PrimordialParams.make(logA=one * math.log(2e-9 * 1e10), ns=one * 0.965)
        mp = compute_matter_power(bg, pp, th, zre, yhe, z_outputs=zs,
                                  nonlinear=False, massive_nu=True)
        s8[dt] = [float(v) for v in mp.sigma8_z[0]]
    for dt in (F32, F64):
        log(f"  sigma8 at mnu = 0.07 eV ({str(dt)[6:]}): " + ", ".join(
            f"z={z}: {v:.6f} ({v / r - 1:+.4%} vs CAMB {r})"
            for z, v, r in zip(zs, s8[dt], CAMB_SIGMA8_MNU.values())))
    for z, v, r in zip(zs, s8[F32], CAMB_SIGMA8_MNU.values()):
        require(abs(v / r - 1) < CAMB_MNU_TOL,
                f"float32 sigma8({z}) at mnu = 0.07 eV within 1.5% of CAMB")
    return s8


def iso_response(dev):
    """Phase 10: the base_w_wa posterior with alpha1 also free, float64, at
    EXT_POINT["w0wa"] and alpha1 giving the admixture amplitudes 0, ISO_B,
    -ISO_B, 2 ISO_B (one chain each) through the slow and semi stages (the
    DE-fluid instantiation with isocurvature ICs): the unlensed TT is
    quadratic in the amplitude, C(2b) = C(0) + 2 (C(b) - C(-b)) / 2 + 4
    ((C(b) + C(-b)) / 2 - C(0)) (tests/test_isocurvature.py, rtol 5e-4,
    atol 1e-6 muK^2), and the pure-isocurvature part is >= 0."""
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.models.cls import cls_from_cl_transfers
    post = ext_posterior(dev, "w0wa", LikelihoodList(), F64, alpha1=True)
    require(post._iso_enabled and post.de_perturbations
            and not post.massive_nu_hierarchy, "w0wa + alpha1: the switches")
    amp = np.array([0.0, ISO_B, -ISO_B, 2 * ISO_B])
    P = np.tile(bestfit_vector(post, EXT_POINT["w0wa"]), (4, 1))
    P[:, [p.name for p in post.space.varying].index("alpha1")] = \
        np.sign(amp) * amp ** 2 / (1 + amp ** 2)
    full = post.embed_full(torch.as_tensor(P, dtype=F64, device=dev))
    got = post.iso_amplitude(full)
    require(float((got.cpu() - torch.as_tensor(amp)).abs().max()) < 1e-12,
            "alpha1 -> amplitude map")
    slow = post.stage_slow(full)
    semi = post.stage_semi(full, slow)
    raw = cls_from_cl_transfers(slow["clt"], post._primordial(full),
                                lmax=post.lmax + post.lens_margin)
    tt = (raw.tt * MUK2).cpu().numpy()
    t0, tp, tm, t2 = tt
    iso_b2 = 0.5 * (tp + tm) - t0
    pred = t0 + (tp - tm) + 4.0 * iso_b2
    excess = np.abs(t2 - pred) / (ISO_ATOL + ISO_RTOL * np.abs(pred))
    log(f"  isocurvature at amplitudes {amp.tolist()}: unlensed TT, l <= "
        f"{post.lmax + post.lens_margin}: |C(2b) - quadratic| at most "
        f"{float(np.abs(t2 - pred).max()):.3e} muK^2, {float(excess.max()):.3e} of "
        f"the tolerance; pure-iso TT at l=10 {float(iso_b2[8]):.4f}, l=150 "
        f"{float(iso_b2[148]):.4f} muK^2 (b = {ISO_B})")
    require(bool(np.isfinite(tt).all()) and bool(torch.isfinite(semi["cls"]).all()),
            "isocurvature C_l finite")
    require(bool((iso_b2 > -1e-8 * np.abs(t0)).all()), "pure-iso TT >= 0")
    require(float(excess.max()) <= 1.0, "isocurvature TT quadratic in the amplitude")
    return float(np.abs(t2 - pred).max())


def check_sync(fn):
    """Whether `fn` waits for the card: a ~50 ms sleep kernel is queued
    first, and a call that returns after it has run synchronised. Returns
    (synchronised, the call's host ms, the sync-debug warnings it raised,
    the source lines that raised them)."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda._sleep(int(1e8))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        t0 = time.time()
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = 1e3 * (time.time() - t0)
    torch.cuda.synchronize()
    stall = torch.cuda.Event(enable_timing=True)
    sleep = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(int(1e8))
    stall.record()
    torch.cuda.synchronize()
    sleep_ms = sleep.elapsed_time(stall)
    sites = [f"{os.path.relpath(w.filename, HERE)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    return host_ms > 0.8 * sleep_ms, host_ms, len(sites), sorted(set(sites))


def drive_spt(dev, tmp, fid):
    """Phase 11: the SPT configuration on the flagship (theta LCDM, halofit
    lensing, table LOS, full width). SPTpol TE/EE (56 bins a spectrum to l
    = 8000), SPTpol BB (150x150, 95x150, 95x95) and an SPT-SZ-shaped TT set
    (47 Gaussian bandpowers, calibration, aberration) raise lmax to 8001;
    lmax_computed = 2508 and a template written from phase 3's float64
    lensed spectrum by write_highl_template fills above. The sets are
    written from the port's float64 theory at the best fit (the splice
    included), without scatter. Checks: the LOS (K2a) at 2508 + 150 and at
    the flagship's shape, lensing (K3) 2507 l wide; the float32 C_l above
    2508 equal to TT(2508) / template TT(2508) times the template (float32
    rounding), phi-phi 0 there; float32 C_l within 1% of float64 to l =
    2000; -logL at the best fit equal to its constant in float64 and within
    SPT_F32_TOL of it in float32; SPT_SEGMENTS staged 16-step segments,
    each slow step launching K4, K1, K2a once and each semi step K3 once;
    BK-Planck (a BK15-shaped set) and CMBLikes in HL and fullsky-exact
    mode on the cached float32 and float64 theory, finite and within
    SPT_F32_TOL. Returns the launch counts of the run and per segment."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch import pipeline as pl
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.bkplanck import BKPlanckLikelihood
    from cosmomc_tpu_torch.likelihoods.cmblikes import CMBLikes
    from cosmomc_tpu_torch.likelihoods.sptpol import (SPTpolBBLikelihood,
                                                      SPTpolTEEELikelihood)
    from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    sync = torch.cuda.synchronize
    path = lambda name: os.path.join(tmp, "spt", name)
    par = ThetaParameterization()
    table = synthetic_bbn_table()
    os.makedirs(path(""), exist_ok=True)
    tmpl = sd.write_highl_template(path("HighL_lensedCls_synthetic.dat"),
                                   fid["cls"].double().cpu().numpy(), SPT_LMAX)

    def posterior(likes, dtype):
        space = par.default_space()
        space.get("tau").prior_mean = 0.0544
        space.get("tau").prior_std = 0.0073
        return pl.CMBPosterior(par, space, likes, bbn_table=table, device=dev,
                               dtype=dtype, lmax_computed=SPT_LMAX_COMPUTED,
                               highl_template=tmpl)

    def at(post, dtype, n=1):
        return torch.as_tensor(np.tile(bestfit_vector(post), (n, 1)),
                               dtype=dtype, device=dev)

    def readers(sets):
        return [SPTpolTEEELikelihood(sets[0], device=dev),
                SPTpolBBLikelihood(sets[1], device=dev),
                CMBLikes(sets[2], name="sptsz_synthetic", device=dev)]

    def likelihood_list(likes):
        out = LikelihoodList()
        for like in likes:
            out.add(like)
        return out

    # 1. the float64 theory at the best fit on the sets' layouts
    layout = readers([sd.write_sptpol_teee(path("teee0")),
                      sd.write_sptpol_bb(path("bb0")),
                      sd.write_cmblikes_tt(path("tt0"))])
    post64 = posterior(likelihood_list(layout), F64)
    require((post64.lmax, post64.lmax_computed) == (SPT_LMAX, SPT_LMAX_COMPUTED),
            "the likelihoods raise lmax to 8001 over lmax_computed 2508")
    full = post64.embed_full(at(post64, F64))
    slow64 = post64.stage_slow(full)
    semi64 = post64.stage_semi(full, slow64)
    theory64 = post64.assemble_theory(slow64, semi64)

    # 2. the sets written there
    sets = [sd.write_sptpol_teee(path("teee"),
                                 sd.sptpol_bandpowers(layout[0], theory64)),
            sd.write_sptpol_bb(path("bb"), sd.sptpol_bandpowers(layout[1],
                                                                theory64)),
            sd.write_cmblikes_tt(path("tt"), sd.cmblikes_bandpowers(
                layout[2], semi64["cls"])[:, 0])]
    likes = readers(sets)
    post = posterior(likelihood_list(likes), F32)
    post64 = posterior(likelihood_list(readers(sets)), F64)

    # 3. the float32 theory (8 chains at the best fit), with the LOS and
    # lensing calls' multipoles recorded
    seen = {"los": [], "lens": [], "lensed": []}
    real_los, real_lens = pl.compute_cl_transfers, pl.lens_cls

    def los(*a, **k):
        seen["los"].append(k["lmax"])
        return real_los(*a, **k)

    def lens(*a, **k):
        seen["lens"].append(k["lmax_lensed"])
        out = real_lens(*a, **k)
        seen["lensed"].append(out.tt.shape[-1])
        return out
    pl.compute_cl_transfers, pl.lens_cls = los, lens
    try:
        full32 = post.embed_full(at(post, F32, NCHAINS))
        t0 = time.time()
        slow32 = post.stage_slow(full32)
        semi32 = post.stage_semi(full32, slow32)
        sync()
        log(f"phase 11: theory at the best fit (float32, {NCHAINS} chains) "
            f"{time.time() - t0:.2f} s; lmax {post.lmax}, lmax_computed "
            f"{post.lmax_computed}")
        clt = slow32["clt"]
        log(f"  K2a: l {int(clt.ls.min())}..{int(clt.ls.max())}, "
            f"{tuple(clt.dT.shape[1:])} (sampled l, fine k); K3 lensed width "
            f"{seen['lensed'][-1]}")
        require(int(clt.ls.max()) == SPT_LMAX_COMPUTED + post.lens_margin
                and tuple(clt.dT.shape[1:]) == FLAGSHIP_K2A_SHAPE,
                "K2a at the flagship's shape (l to 2508 + 150)")
        require(seen["lensed"][-1] == FLAGSHIP_LENSED_L,
                "K3's lensed output 2507 l wide")
        cls32, cls64 = semi32["cls"], semi64["cls"][0]
        require(cls32.shape == (NCHAINS, 4, 4, SPT_LMAX + 1), "C_l to 8001")
        lm, hi = SPT_LMAX_COMPUTED, slice(SPT_LMAX_COMPUTED + 1, SPT_LMAX + 1)
        t64 = post64._highl
        norm = cls32[:, 0, 0, lm].double() / t64[lm, 0]
        errs = {}
        for n, (i, j), col in (("TT", (0, 0), 0), ("EE", (1, 1), 1),
                               ("BB", (2, 2), 2), ("TE", (1, 0), 3)):
            want = norm[:, None] * t64[hi, col]
            errs[n] = rel_err(cls32[:, i, j, hi], want)
        log("  splice above 2508, float32 C_l against norm x template, max err "
            "relative to each spectrum's maximum there: " + ", ".join(
                f"{n} {v:.2e}" for n, v in errs.items())
            + f"; norm {float(norm[0]):.6f}")
        for n, v in errs.items():
            require(v < SPLICE_RTOL, f"spliced {n} = norm x template")
        require(not bool(cls32[:, 3, 3, hi].any()), "phi-phi 0 above 2508")
        e = {n: rel_err(cls32[0, i, j, 2:2001], cls64[i, j, 2:2001])
             for n, i, j in (("TT", 0, 0), ("TE", 1, 0), ("EE", 1, 1),
                             ("BB", 2, 2), ("PP", 3, 3))}
        e["TT above 2508"] = rel_err(cls32[0, 0, 0, hi], cls64[0, 0, hi])
        log("  C_l float32 vs float64, max rel err: "
            + ", ".join(f"{n} {v:.2e}" for n, v in e.items()))
        for n, v in e.items():
            require(v < 1e-2, f"phase 11 float32 {n} within 1% of float64")
        require(bool(torch.isfinite(cls32).all()), "finite spliced C_l")

        # 4. -logL at the best fit, float32 and float64, against its
        # constant: the SPTpol sets' half ln det Cov, the tau prior
        tau = BESTFIT["tau"]
        const = (likes[0].half_logdet + likes[1].half_logdet
                 + 0.5 * ((tau - 0.0544) / 0.0073) ** 2)
        m32 = float(post.logpost()(at(post, F32))[0][0])
        m64 = float(post64.logpost()(at(post64, F64))[0][0])
        log(f"  -logL at the best fit: float32 {m32:.6f}, float64 {m64:.9f}, "
            f"constant {const:.9f} (half ln det Cov: TE/EE "
            f"{likes[0].half_logdet:.6f}, BB {likes[1].half_logdet:.6f}); "
            f"float32 - float64 {m32 - m64:.3e}")
        require(abs(m64 - const) < 1e-6, "float64 -logL at its constant")
        require(abs(m32 - m64) < SPT_F32_TOL, "float32 -logL near float64's")
        require(abs(const) > 1.0, "the constant is not 0")

        # 5. the staged sampler: SPT_SEGMENTS segments, one slow step each
        prop = post.make_proposal(oversample_fast=4)
        w = np.array([p.propose_width for p in post.space.varying])
        prop.set_covariance(np.diag(w ** 2))
        sampler = StagedMetropolisSampler(prop, post, seed=0)
        expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
        rng = np.random.default_rng(0)
        P0 = start_points(post, rng, F32)
        stage_fast = post.stage_fast
        stage_s, calls = instrument_stages(post)
        kernels.reset_launches()
        seen["los"].clear()
        seen["lens"].clear()
        t0 = time.time()
        state = sampler.init_state(P0)
        sync()
        t_init = time.time() - t0
        at_init, calls_init = dict(kernels.launches), dict(calls)
        seg_s, out = [], None
        for _ in range(SPT_SEGMENTS):
            sched = prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                                       expensive_blocks=expensive)
            t0 = time.time()
            state, out = sampler.run_segment(state, sched)
            sync()
            seg_s.append(time.time() - t0)
        launches = dict(kernels.launches)
        per_segment = {n: (launches[n] - at_init[n]) / SPT_SEGMENTS
                       for n in launches}
        run_calls = {n: calls[n] - calls_init[n] for n in calls}
    finally:
        pl.compute_cl_transfers, pl.lens_cls = real_los, real_lens
    steps = SPT_SEGMENTS * SEG_STEPS * NCHAINS
    log(f"  init {t_init:.2f} s; {SPT_SEGMENTS} segments {sum(seg_s):.2f} s "
        f"({', '.join(f'{v:.3f}' for v in seg_s)}), {steps / sum(seg_s):.2f} "
        "chain steps/s; stage wall per call: " + ", ".join(
            f"{n} {1e3 * stage_s[n] / max(calls[n], 1):.1f} ms "
            f"({calls[n]} calls)" for n in stage_s))
    log("  launches in the run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment)
        + f"; stage calls in the segments: {json.dumps(run_calls)}")
    want = {"recfast": calls["slow"], "boltzmann": calls["slow"],
            "los": calls["slow"], "lensing": calls["semi"]}
    for n in KERNELS:
        require(launches[n] == want.get(n, 0),
                f"{n} launched {want.get(n, 0)} times on the spt path")
    require(set(seen["los"]) == {SPT_LMAX_COMPUTED + post.lens_margin}
            and set(seen["lens"]) == {SPT_LMAX_COMPUTED},
            "the LOS and lensing stay at lmax_computed in every call")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.3f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL on the spt path")
    require(bool(torch.isfinite(out.derived).all()), "spt: finite derived")
    require(not bool(out.error.any()), "spt: no error points")
    s_fast = check_sync(lambda: stage_fast(state.P, state.slow, state.semi))
    log(f"  fast stage (SPTpol x2 + SPT-SZ TT, {NCHAINS} chains): waits for "
        f"the card {s_fast[0]} (host {s_fast[1]:.1f} ms, sync warnings "
        f"{s_fast[2]} at {', '.join(s_fast[3])})")

    # 6. BK-Planck and CMBLikes HL / fullsky exact on the cached theory
    th32 = post.assemble_theory(slow32, semi32)
    bk0 = BKPlanckLikelihood(sd.write_bk_like(path("bk0")), device=dev)
    other = {
        "BK-Planck (HL, 3 B maps)": BKPlanckLikelihood(sd.write_bk_like(
            path("bk"), sd.cmblikes_bandpowers(bk0, semi64["cls"])), device=dev)}
    for approx, kw in (("HL", {}), ("exact", dict(lrange=(2, 200)))):
        l0 = CMBLikes(sd.write_cmblikes_tt(path(f"tt_{approx}0"),
                                           like_approx=approx, **kw),
                      device=dev)
        vals = sd.cmblikes_bandpowers(l0, semi64["cls"])[:, 0]
        other[f"CMBLikes {approx} (TT)"] = CMBLikes(sd.write_cmblikes_tt(
            path(f"tt_{approx}"), vals, like_approx=approx, **kw), device=dev)
    for name, like in other.items():
        nu = torch.as_tensor([[p.center for p in like.nuisance if p.varying]]
                             * NCHAINS, dtype=F64, device=dev)
        v64 = like.log_like(theory64, nu[:1])
        like.log_like(th32, nu)
        ms, v32 = timed(lambda: like.log_like(th32, nu), reps=5)
        synced, host_ms, n_sync, sites = check_sync(
            lambda: like.log_like(th32, nu))
        d = float((v32.double() - v64).abs().max())
        log(f"  {name}: -logL float64 theory {float(v64[0]):.6e}, float32 "
            f"theory {float(v32[0]):.6e} (max |diff| {d:.3e}), {ms:.3f} ms a "
            f"call ({NCHAINS} chains); waits for the card {synced} (host "
            f"{host_ms:.1f} ms, sync warnings {n_sync} at {', '.join(sites)})")
        require(bool(torch.isfinite(v32).all()) and bool(torch.isfinite(v64).all()),
                f"{name}: finite")
        require(d < SPT_F32_TOL, f"{name}: float32 theory within "
                f"{SPT_F32_TOL} of float64")
    return launches, per_segment


def sz_cash_by_hand(counts, DN):
    """The Cash -logL of theory counts DN (nz, nq) against a catalogue
    written from integer `counts` plus synthetic.SZ_MISSING_Q rows with no
    redshift, recomputed from the counts in numpy: each missing row scales
    its S/N column so the column total grows by one, then Stirling's
    ln n! above 10 and the exact one below (szcounts.f90:1769-1944)."""
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods import szcounts as sz
    ny = counts.shape[1] - 1
    lc = sz.LOGY_MIN + (np.arange(ny + 1) + 0.5) * sz.DLOGY
    qlo, qhi = 10.0 ** (lc - 0.5 * sz.DLOGY), 10.0 ** (lc + 0.5 * sz.DLOGY)
    n = counts.astype(float)
    for q in sd.SZ_MISSING_Q:
        j = ny if q >= qhi[ny - 1] else int(np.nonzero((qlo <= q) & (q < qhi))[0][0])
        if n[:, j].sum() > 0:
            n[:, j] *= (n[:, j].sum() + 1.0) / n[:, j].sum()
    lnf = np.array([0.0 if v == 0 else
                    (0.918939 + (v + 0.5) * math.log(v) - v if v > 10
                     else math.lgamma(math.floor(v) + 1.0))
                    for v in n.ravel()]).reshape(n.shape)
    term = np.where(DN > 0, n * np.log(np.maximum(DN, 1e-300)) - DN - lnf, 0.0)
    return -float(term.sum())


def abundance_by_hand(tab, ds, ombh2, dn):
    """An abundance set's Gaussian at (ombh2, DeltaN) from the numbers in
    its .dataset and a bilinear lookup in the BBN grids (numpy)."""
    keys = {}
    with open(ds) as f:
        for line in f:
            k, _, v = line.partition("=")
            keys[k.strip()] = v.strip()
    x = (ombh2 - tab.ombh2_0) / tab.ombh2_step
    y = (dn - tab.dn_0) / tab.dn_step
    i, j = int(x), int(y)
    fx, fy = x - i, y - j

    def at(g):
        g = np.asarray(g)
        return ((1 - fx) * (1 - fy) * g[i, j] + fx * (1 - fy) * g[i + 1, j]
                + (1 - fx) * fy * g[i, j + 1] + fx * fy * g[i + 1, j + 1])
    dh = keys["measurement"] == "D/H"
    pred = at(tab.dh if dh else tab.ypbbn)
    terr = float(keys.get("theory_effective_error", 0.0)) or at(
        tab.sig_dh if dh else tab.sig_yp)
    t = pred + float(keys.get("theory_bias_offset", 0.0)) - float(keys["mean"])
    return 0.5 * t * t / (float(keys["error"]) ** 2 + terr ** 2)


def drive_lss_bbn(dev, tmp):
    """Phase 12, part 1: the LSS-only configuration with a BBN prior as
    cosmomc_tpu/driver.py builds it (parameterization = astro:
    AstroParameterization and CMBPosterior(use_cmb=False,
    matter_power=True), use_WL, use_SZ, abundance datasets): a DES 1YR-shaped 3x2pt set, a Planck 2015-shaped
    SZ set (dN/dz/dq, Tinker), D/H and Yp abundances on a written BBN grid
    and the synthetic DR12 BAO set with f_sigma8 rows, each written from
    the port's float64 theory at the centres. The matter grid at full
    width (216 k to 8/Mpc, 6144 steps), z_pk extended by WL's
    required_zmax and SZ's 1.2, the theory in float32, the likelihoods in
    float64. At the centres in float64: WL's chi^2/2 is 0, each abundance
    its Gaussian by hand, SZ's Cash sum recomputed in numpy, the
    per-likelihood table summing to the fast stage's total; the float32
    theory within LSS_F32_TOL of each. Then StagedMetropolisSampler on
    LSS_NCHAINS chains: init, LSS_SEGMENTS segments of SEG_STEPS with one
    slow step each, launching K4 and K1 once a slow step and nothing
    else; each new likelihood's ms a call and whether it waits for the
    card. Returns the launch counts."""
    from cosmomc_tpu_torch import kernels
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.abundances import AbundanceLikelihood
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.szcounts import SZCountsLikelihood
    from cosmomc_tpu_torch.likelihoods.wl import WLLikelihood
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    from cosmomc_tpu_torch.params.parameterizations import AstroParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    t_phase = time.time()
    d = os.path.join(tmp, "lss_bbn")
    par = AstroParameterization()
    table = load_bbn_table(sd.write_bbn_table(os.path.join(
        d, sd.BBN_TABLE_NAME)))
    abund = [sd.write_abundance(d, n, **sd.ABUNDANCE_SETS[n])
             for n in ("D_Cooke2017", "Yp_Aver2015")]
    des = sd.write_des_wl(d)
    sd.write_sz_selection(d)
    sd.write_sz_catalogue(d, np.zeros((11, 5), int))
    bao0 = BAOLikelihood(sd.write_dr12_bao(d, fsigma8=True), device=dev)

    def posterior(likes, dtype):
        return CMBPosterior(par, par.default_space(), likes, bbn_table=table,
                            use_cmb=False, matter_power=True, device=dev,
                            dtype=dtype)

    def centres(post, dtype, n=1):
        v = np.array([p.center for p in post.space.varying])
        return torch.as_tensor(np.tile(v, (n, 1)), dtype=dtype, device=dev)

    # 1. the float64 theory at the centres, on the full likelihoods' grids
    wl_all = WLLikelihood(des, dataset_overrides={
        "data_selection": "DES_1YR_synthetic" + sd.DES_ALL_SCALES}, device=dev)
    sz0 = SZCountsLikelihood(d, device=dev)
    req = LikelihoodList()
    req.add(wl_all)
    req.add(sz0)
    p64 = posterior(req, F64)
    full = p64.embed_full(centres(p64, F64))
    slow = p64.stage_slow(full)
    th64 = p64.assemble_theory(slow, p64.stage_semi(full, slow))
    log(f"phase 12: z_pk {len(p64.z_pk)} redshifts to {max(p64.z_pk):.4f} "
        f"(WL required_zmax {wl_all.required_zmax:.4f}, SZ 1.2); "
        f"sigma8(0) {float(th64.sigma8_z[0, 0]):.6f} (float64)")

    # 2. the sets, written from that theory
    des = sd.write_des_wl(d, sd.des_wl_rows(wl_all, th64))
    nu_sz = sz0.nuisance_values(torch.as_tensor(
        [[p.center for p in sz0.nuisance if p.varying]], dtype=F64, device=dev))
    counts = np.rint(sz0.theory_counts(th64, nu_sz)[0].cpu().numpy()).astype(int)
    sd.write_sz_catalogue(d, counts)
    dr12 = sd.write_dr12_bao(d, bao0.theory_vector(th64)[0].cpu().numpy(),
                             fsigma8=True)
    likes = LikelihoodList()
    likes.add(WLLikelihood(des, device=dev))
    likes.add(SZCountsLikelihood(d, device=dev))
    for ds in abund:
        likes.add(AbundanceLikelihood(ds, device=dev))
    likes.add(BAOLikelihood(dr12, device=dev, dtype=F64))
    wl, sz = likes.likes[0], likes.likes[1]
    log(f"  DES: {wl.num_used} of {sd.N_DES_ROWS} rows after the cuts; SZ: "
        f"{sz.ncat} clusters at q >= 6 ({sz.nmiss} without a redshift), "
        f"{len(sz.skyfracs)} patches x {len(sz.thetas)} theta, f_sky "
        f"{sz.fsky:.3f}")
    require(400 <= wl.num_used <= 500, "DES cuts keep about half the rows")
    require(150 <= int(counts.sum()) <= 1000, "a few hundred SZ clusters")

    # 3. at the centres, float64 and float32 theory
    post64, post32 = posterior(likes, F64), posterior(likes, F32)
    truth = np.array([p.center for p in post64.space.varying])
    per64 = post64.per_likelihood(truth)
    per32 = post32.per_likelihood(truth)
    log("  -logL per likelihood at the centres, float64 theory / float32 "
        "theory: " + ", ".join(f"{n} {per64[n]:.9f} / {per32[n]:.9f}"
                               for n in per64))
    full = post64.embed_full(centres(post64, F64))
    slow64 = post64.stage_slow(full)
    semi64 = post64.stage_semi(full, slow64)
    total, _ = post64.stage_fast(centres(post64, F64), slow64, semi64)
    require(abs(sum(per64.values()) - float(total[0]))
            <= 1e-9 * max(1.0, abs(float(total[0]))),
            "per_likelihood sums to the fast stage's total")
    require(abs(per64[wl.name]) < LSS_WL_ZERO, "WL chi^2/2 = 0 at its theory")
    bg = th64.bg
    for ds, like in zip(abund, likes.likes[2:4]):
        want = abundance_by_hand(table, ds, float(bg.ombh2[0]),
                                 float(bg.nnu[0]) - 3.046)
        require(abs(per64[like.name] - want) <= LSS_HAND_RTOL * abs(want),
                f"{like.name} equals its Gaussian by hand ({want:.12e})")
    DN = sz.theory_counts(th64, nu_sz)[0].cpu().numpy()
    want = sz_cash_by_hand(counts, DN)
    require(abs(per64[sz.name] - want) <= LSS_HAND_RTOL * abs(want),
            f"SZ Cash -logL equals the sum from its counts ({want:.9f})")
    for n in per64:
        require(abs(per32[n] - per64[n]) < LSS_F32_TOL,
                f"{n}: float32 theory within {LSS_F32_TOL} of float64")

    # 4. the staged sampler, float32 theory
    prop = post32.make_proposal()
    w = np.array([p.propose_width for p in post32.space.varying])
    prop.set_covariance(np.diag(w ** 2))
    sampler = StagedMetropolisSampler(prop, post32, seed=0)
    expensive = [b for b, c in enumerate(sampler.block_class) if c == 0]
    rng = np.random.default_rng(0)
    lo = np.array([p.min for p in post32.space.varying])
    hi = np.array([p.max for p in post32.space.varying])
    P0 = torch.as_tensor(np.clip(truth + 0.3 * w * rng.standard_normal(
        (LSS_NCHAINS, len(w))), lo, hi), dtype=F32, device=dev)
    scheds = [prop.make_schedule(SEG_STEPS, rng, slow_every=SEG_STEPS,
                                 expensive_blocks=expensive)
              for _ in range(LSS_SEGMENTS)]
    stage_s, calls = instrument_stages(post32)
    torch.cuda.synchronize()
    kernels.reset_launches()
    state = sampler.init_state(P0)
    torch.cuda.synchronize()
    at_init = dict(kernels.launches)
    t0 = time.time()
    for sched in scheds:
        state, out = sampler.run_segment(state, sched)
    torch.cuda.synchronize()
    t_run = time.time() - t0
    launches = dict(kernels.launches)
    per_segment = {n: (launches[n] - at_init[n]) / LSS_SEGMENTS
                   for n in launches}
    log(f"  {LSS_SEGMENTS} segments x {SEG_STEPS} steps x {LSS_NCHAINS} chains "
        f"in {t_run:.3f} s ({LSS_SEGMENTS * SEG_STEPS * LSS_NCHAINS / t_run:.1f} "
        f"chain steps/s); stage wall time: " + ", ".join(
            f"{n} {stage_s[n]:.3f} s / {calls[n]} calls" for n in stage_s))
    log("  launches in the lss_bbn run: " + json.dumps(launches)
        + "; per segment: " + json.dumps(per_segment))
    for n in KERNELS:
        want = 1 if n in PATH_KERNELS["lss_bbn"] else 0
        require(at_init[n] == want and per_segment[n] == want,
                f"{n} launched {want} time(s) at init and a segment on the "
                f"lss_bbn path")
    mll = state.mloglike
    log("  -logL per chain: " + " ".join(f"{float(v):.2f}" for v in mll)
        + f"; acceptance {float(out.accept.float().mean()):.3f}")
    require(bool(torch.isfinite(mll).all()) and bool((mll < 1e29).all()),
            "finite -logL on the lss_bbn path")
    require(bool(torch.isfinite(out.derived).all()), "lss_bbn: finite derived")
    require(not bool(out.error.any()), "lss_bbn: no error points")

    # 5. the fast stage and each new likelihood: ms a call, host waits
    stage_fast = type(post32).stage_fast.__get__(post32)
    fast = lambda: stage_fast(state.P, state.slow, state.semi)
    fast_ms, _ = timed(fast, reps=3)
    s_fast = check_sync(fast)
    log(f"  fast stage ({LSS_NCHAINS} chains): {fast_ms:.3f} ms a call; "
        f"waits for the card {s_fast[0]} (host {s_fast[1]:.1f} ms, sync "
        f"warnings {s_fast[2]} at {', '.join(s_fast[3])})")
    th32 = post32.assemble_theory(state.slow, state.semi)
    for like in likes.likes[:4]:
        cols = post32.slices[like.name]
        nu = state.P[:, cols]
        like.log_like(th32, nu)
        ms, _ = timed(lambda: like.log_like(th32, nu), reps=3)
        synced, host_ms, n_sync, sites = check_sync(
            lambda: like.log_like(th32, nu))
        log(f"  {like.name}: {ms:.3f} ms a call ({LSS_NCHAINS} chains); waits "
            f"for the card {synced} (host {host_ms:.1f} ms, sync warnings "
            f"{n_sync} at {', '.join(sites)})")
        require(n_sync == 0, f"{like.name} adds no host-wait site")
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    sz.log_like(th32, state.P[:, post32.slices[sz.name]])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f"  SZ peak memory above its inputs: {peak / 2 ** 20:.1f} MiB for "
        f"{LSS_NCHAINS} chains in blocks of {sz.chain_block} "
        f"({peak / 2 ** 20 / LSS_NCHAINS:.1f} MiB a chain)")
    require(peak < 5 * 2 ** 30, "SZ peak under ~4 GB whatever the chains")
    log(f"  phase 12 part 1 took {time.time() - t_phase:.1f} s")
    return launches, per_segment


def action4_table(post):
    """Phase 12, part 2: the action=4 per-likelihood table on phase 3's
    posterior (plik_lite + tau prior, float32) at the best fit: its values
    sum to that point's -logL without priors (the raw posterior)."""
    truth = bestfit_vector(post)
    table = post.per_likelihood(truth)
    raw, _ = post.raw_logpost()(torch.as_tensor(truth[None], dtype=post.dtype,
                                                device=post.device))
    log("phase 12: action=4 table on the flagship at the best fit: "
        + ", ".join(f"{n} {v:.6e}" for n, v in table.items())
        + f"; -logL without priors {float(raw[0]):.6e}")
    require(list(table) == [like.name for like in post.likes.likes],
            "a row per likelihood")
    require(abs(sum(table.values()) - float(raw[0]))
            <= 1e-5 * max(1.0, abs(float(raw[0]))),
            "the action=4 table sums to -logL without priors")


def write_ini(path, keys):
    """An ini file of `key = value` lines."""
    with open(path, "w") as f:
        f.writelines(f"{k} = {v}\n" for k, v in keys.items())
    return path


def smi_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def port_cli(args, what, expect_rc=0):
    """`python -m <args>` from the checkout, as a user runs it; its output
    goes to the log, its exit code must be `expect_rc`."""
    return port_clis([(args, what, expect_rc)])[0]


def port_clis(runs):
    """Each (args, what, expect_rc) of `runs` as port_cli runs it, all
    started together (each new process builds its host tables anew, so
    they overlap); returns their standard outputs in order."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-m", *args], cwd=HERE, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for args, _, _ in runs]
    outs = []
    try:
        for proc, (_, what, expect_rc) in zip(procs, runs):
            out, err = proc.communicate(timeout=600)
            for line in (out + err).strip().splitlines()[-12:]:
                log(f"  | {line}")
            require(proc.returncode == expect_rc,
                    f"{what} exits {expect_rc} (got {proc.returncode})")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def mll_at(post, P):
    """-logL (float64 numpy) of `post` at the (C, n) points P."""
    with torch.no_grad():
        return post.logpost()(torch.as_tensor(
            P, dtype=post.dtype, device=post.device))[0].double().cpu().numpy()


def driver_flagship(dev, d, fid, times):
    """Phase 13's steps 1, 2, 3 and 5 (drive_driver) on the flagship ini
    written under `d`; adds each step's wall time to `times`. Returns
    step 2's launch counts and its launches a segment."""
    from cosmomc_tpu_torch import driver, kernels
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.likelihoods.bao import BAOLikelihood
    from cosmomc_tpu_torch.likelihoods.base import LikelihoodList
    from cosmomc_tpu_torch.likelihoods.hst import HSTLikelihood
    from cosmomc_tpu_torch.likelihoods.pliklite import PlikLiteLikelihood
    from cosmomc_tpu_torch.models.bbn import load_bbn_table
    from cosmomc_tpu_torch.models.lensing import lens_cls
    from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization
    from cosmomc_tpu_torch.pipeline import CMBPosterior
    from cosmomc_tpu_torch.sampling import importance, runner
    from cosmomc_tpu_torch.sampling.staged import StagedMetropolisSampler

    bbn = sd.write_bbn_table(os.path.join(d, "bbn_grid.dat"))
    hst = dict(H0=73.48, H0_err=1.66)
    flag = write_ini(os.path.join(d, "flagship.ini"), {
        "file_root": os.path.join(d, "chains", "flagship"),
        "pliklite_dataset": fid["ds"], "bao_dataset[DR12]": fid["dr12"],
        "prior[tau]": "0.0544 0.0073", "bbn_table": bbn,
        "Hubble_H0": hst["H0"], "Hubble_H0_err": hst["H0_err"],
        "device": dev.type})

    def by_hand(with_hst):
        """The flagship ini's posterior in float64, built without the
        driver."""
        par = ThetaParameterization()
        space = par.default_space()
        space.get("tau").prior_mean, space.get("tau").prior_std = 0.0544, 0.0073
        likes = LikelihoodList()
        likes.add(PlikLiteLikelihood(fid["ds"], device=dev, dtype=F64))
        likes.add(BAOLikelihood(fid["dr12"], name="DR12", device=dev, dtype=F64))
        if with_hst:
            likes.add(HSTLikelihood(**hst))
        return CMBPosterior(par, space, likes, bbn_table=load_bbn_table(bbn),
                            device=dev, dtype=F64)

    # 1. the CLI, action 4
    t0 = time.time()
    hand = by_hand(False)
    centre = np.array([p.center for p in hand.space.varying])
    mll_hand = float(mll_at(hand, centre[None])[0])
    cli = ["cosmomc_tpu_torch", flag, "action=4", "use_float64=T"]
    out, _ = port_clis([
        (cli + [f"test_check_compare={mll_hand!r}"], "the CLI's action 4", 0),
        (cli + [f"test_check_compare={mll_hand + 1.0!r}"],
         "the CLI's action 4 one above the value", 1)])
    mll_cli = float(out.split("Test -log(Like) =")[1].split()[0])
    log(f"phase 13: CLI action=4 -logL {mll_cli:.10f}, by hand "
        f"{mll_hand:.10f} (rel diff {abs(mll_cli - mll_hand) / abs(mll_hand):.2e})")
    require(abs(mll_cli - mll_hand) <= DRIVER_MLL_RTOL * abs(mll_hand),
            "the CLI's -logL equals the posterior built by hand")
    times["1 CLI action 4"] = time.time() - t0

    # 2. action 0 on the flagship ini, its launches counted alone; rows are
    # written after one accept a block (RunConfig's default of 50 would
    # take far more than DRIVER_SEGMENTS segments)
    root0 = os.path.join(d, "chains", "flagship")
    at_init = {}
    real_init = StagedMetropolisSampler.init_state

    def init_state(self, P0):
        state = real_init(self, P0)
        torch.cuda.synchronize()
        at_init.update(kernels.launches)
        return state

    @dataclasses.dataclass
    class OneAcceptConfig(runner.RunConfig):
        burn_accepts_per_block: int = 1
    real_cfg = runner.RunConfig
    StagedMetropolisSampler.init_state = init_state
    runner.RunConfig = OneAcceptConfig
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.time()
        rc = driver.run_ini(flag, dict(
            action="0", use_float64="F", num_chains=str(NCHAINS),
            segment_steps=str(SEG_STEPS),
            samples=str(DRIVER_SEGMENTS * SEG_STEPS), MPI_R_Stop="0",
            feedback="0"))
        torch.cuda.synchronize()
        times["2 action 0"] = time.time() - t0
        launches = dict(kernels.launches)
    finally:
        StagedMetropolisSampler.init_state = real_init
        runner.RunConfig = real_cfg
    per_segment = {n: (launches[n] - at_init[n]) / DRIVER_SEGMENTS
                   for n in launches}
    log("phase 13: action 0 launches " + json.dumps(launches)
        + "; per segment " + json.dumps(per_segment))
    require(rc == 0, "action 0 exits 0")
    for n in KERNELS:
        if n in PATH_KERNELS["driver"]:
            require(launches[n] > 0, f"{n} launched by action 0")
        else:
            require(launches[n] == 0, f"{n} not launched by action 0")
    for ext in ("_1.txt", ".paramnames", ".ranges", ".converge_stat",
                ".inputparams", ".margestats", ".covmat", ".likestats"):
        require(os.path.isfile(root0 + ext), f"action 0 wrote {ext}")
    samples = MCSamples.load(root0, ignore_frac=0.0)
    require(samples.samples.shape[1] == hand.space.num_varying + hand.num_derived
            and len(samples.weights) > 0
            and bool(np.isfinite(samples.samples).all()),
            "MCSamples reads the chains back")
    log(f"  {len(samples.weights)} rows, weight {samples.norm:.0f}, R-1 "
        f"{samples.converge_tests()['R-1']:.3f}")

    # 3. action 1: the chains reweighted with HST added, float64
    got = []
    real_arrays = importance.importance_sample_arrays

    def arrays(*a, **k):
        got.append(real_arrays(*a, **k))
        return got[-1]
    importance.importance_sample_arrays = arrays
    try:
        t0 = time.time()
        rc = driver.run_ini(flag, dict(
            action="1", redo_root=root0, use_HST="T", use_float64="T",
            file_root=os.path.join(d, "chains", "flagship_hst")))
        torch.cuda.synchronize()
        times["3 action 1"] = time.time() - t0
    finally:
        importance.importance_sample_arrays = real_arrays
    w = np.concatenate([r.weights for r in got])
    eff = float(w.sum() ** 2 / (len(w) * (w ** 2).sum()))
    rows = got[0].samples[:3]
    mll_rows = mll_at(by_hand(True), rows)
    err = np.abs(got[0].mloglike[:3] - mll_rows) / np.abs(mll_rows)
    log(f"phase 13: action 1 on {len(w)} rows in blocks of "
        f"{importance.CMB_BATCH}: eff_frac {eff:.4f}; three rows' -logL "
        f"{got[0].mloglike[:3]} vs by hand {mll_rows} (rel {err.max():.2e})")
    require(rc == 0 and 0.0 < eff <= 1.0, "action 1 eff_frac in (0, 1]")
    require(bool((err <= DRIVER_MLL_RTOL).all()),
            "action 1's -logL equals the posterior's own")
    require(os.path.isfile(os.path.join(d, "chains", "flagship_hst_post_1.txt")),
            "action 1 wrote the post chains")

    # 5. the same keys on the flagship ini raise before any launch
    t0 = time.time()
    for over in ({"action": "2"}, {"action": "0", "sampling_method": "hmc"}):
        kernels.reset_launches()
        try:
            driver.run_ini(flag, over)
            raised = False
        except NotImplementedError as e:
            raised = "queue 1 item 4" in str(e)
        require(raised and not any(kernels.launches.values()),
                f"{over} on the flagship raises before any kernel launch")
    # and K3's wrapper, which the semi stage runs, on spectra that want a
    # gradient
    ls = torch.arange(2, 81, dtype=F64, device=dev)
    spectra = torch.ones(4, 1, 79, dtype=F64, device=dev, requires_grad=True)
    kernels.reset_launches()
    try:
        lens_cls(ls, *spectra, lmax_lensed=60)
        raised = False
    except NotImplementedError as e:
        raised = "queue 1 item 4" in str(e)
    require(raised and not any(kernels.launches.values()),
            "lens_cls on the card raises for a gradient before any launch")
    times["5 raises"] = time.time() - t0

    return launches, per_segment


def driver_background(dev, d, bg, times):
    """Phase 13's steps 4 and 6 (drive_driver) on the background ini
    written under `d` from phase 6's sets `bg`; adds each step's wall time
    to `times`. Runs on the CPU too (`dev` the CPU device: the inis then
    carry device = cpu)."""
    from cosmomc_tpu_torch import driver
    from cosmomc_tpu_torch.analysis.mcsamples import MCSamples
    from cosmomc_tpu_torch.likelihoods import synthetic as sd
    from cosmomc_tpu_torch.utils.ini import IniFile

    # 4. action 2 and HMC on the background ini (autograd on the card)
    bgkeys = {"parameterization": "background",
              "bao_dataset[DR12]": bg["dr12"], "bao_dataset[6DF]": bg["sixdf"],
              "sn_dataset[Pantheon]": bg["sn"], "use_HST": "T",
              "Hubble_H0": repr(bg["hst_h0"]), "Hubble_H0_err": "1.66",
              "device": dev.type}
    bgini = write_ini(os.path.join(d, "background.ini"), {
        "file_root": os.path.join(d, "chains", "background"), **bgkeys})
    t0 = time.time()
    require(driver.run_ini(bgini, {"action": "2"}) == 0, "action 2 exits 0")
    times["4 action 2"] = time.time() - t0
    post = driver.build_posterior(IniFile(bgini))
    centre = np.array([p.center for p in post.space.varying])
    mll_c = float(mll_at(post, centre[None])[0])
    root2 = os.path.join(d, "chains", "background")
    with open(root2 + ".minimum") as f:
        mll_min = float(f.read().split("-log(Like) =")[1].split()[0])
    ev = np.linalg.eigvalsh(np.loadtxt(root2 + ".hessian.covmat"))
    log(f"phase 13: action 2 -logL {mll_min:.6f} (centre {mll_c:.6f}); Hessian "
        f"covmat eigenvalues {ev}")
    require(mll_min <= mll_c, ".minimum at or below the centre's -logL")
    require(bool((ev > 0).all()), "the Hessian covmat is positive definite")
    t0 = time.time()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = driver.run_ini(bgini, {
            "action": "0", "sampling_method": "hmc", "MPI_R_Stop": "0",
            "feedback": "0", "file_root": os.path.join(d, "chains", "hmc"),
            **{k: str(v) for k, v in DRIVER_HMC.items()}})
    times["4 HMC"] = time.time() - t0
    log(buf.getvalue().strip())
    acc = float(buf.getvalue().split("accept =")[1].split(",")[0])
    hmc = MCSamples.load(os.path.join(d, "chains", "hmc"), ignore_frac=0.0)
    sig = np.sqrt(np.diag(hmc.cov()))
    means = hmc.means()
    require(rc == 0 and acc > 0.4, "HMC accepts more than 0.4")
    for i, name in enumerate(p.name for p in post.space.varying):
        pull = (means[i] - sd.BACKGROUND_TRUTH[name]) / sig[i]
        log(f"  HMC {name}: mean {means[i]:.6g} +- {sig[i]:.4g} (truth "
            f"{sd.BACKGROUND_TRUTH[name]}, {pull:+.2f} sigma)")
        if name in ("omegam", "H0"):
            require(abs(pull) < 3.0, f"HMC {name} within 3 sigma of the truth")

    # 6. the grid CLI: one background job and its HST importance rerun
    t0 = time.time()
    frag = write_ini(os.path.join(d, "bg_data.ini"), {**bgkeys, "use_HST": "F"})
    settings = os.path.join(d, "grid_settings.json")
    with open(settings, "w") as f:
        json.dump({"params": [[]], "datasets": [[["bg"], [frag]]],
                   "importance_runs": [["HST", {"use_HST": "T"}]],
                   "defaults": {"MPI_R_Stop": "0", "feedback": "0",
                                **{k: str(v) for k, v in DRIVER_GRID.items()}}},
                  f)
    grid = os.path.join(d, "grid")
    port_cli(["cosmomc_tpu_torch.grid", "make", grid, settings], "grid make")
    out = port_cli(["cosmomc_tpu_torch.grid", "run", grid], "grid run")
    require("base_bg: rc=0" in out and "base_bg_post_HST: rc=0" in out,
            "grid run: both jobs exit 0")
    out = port_cli(["cosmomc_tpu_torch.grid", "status", grid], "grid status")
    require("base_bg " in out and "chains=1" in out, "grid status lists the job")
    require(os.path.isfile(os.path.join(grid, "base", "bg_post_HST",
                                        "base_bg_post_HST_post_1.txt")),
            "the importance rerun wrote its chains")
    times["6 grid"] = time.time() - t0


def drive_driver(dev, tmp, fid, bg):
    """Phase 13: the ini driver, `python -m cosmomc_tpu_torch params.ini`,
    and the tools it dispatches to, on inis written from phase 3's plik_lite
    fiducial, phase 5's DR12-shaped BAO set and phase 6's background sets:
      1. the CLI, action 4 on the flagship ini in float64, as a subprocess:
         -logL equal to the same posterior built by hand
         (DRIVER_MLL_RTOL), test_check_compare passing at that value and
         failing (exit 1) one above it;
      2. action 0 on the flagship ini (float32, NCHAINS chains,
         DRIVER_SEGMENTS segments of SEG_STEPS steps, MPI_R_Stop = 0):
         exactly K4, K1, K2a and K3 launched, the chain files and sidecars
         and the GetDist outputs written, MCSamples reading them back;
      3. action 1 on those chains with HST added, float64: eff_frac in
         (0, 1], three rows' new -logL equal to the hand-built posterior's
         (DRIVER_MLL_RTOL);
      4. action 2 and sampling_method = hmc on the background ini, float64
         with autograd on the card: the .minimum at or below the centre's
         -logL, a positive definite Hessian covmat; HMC accepting > 0.4
         with omegam and H0 within 3 pooled sigma of the truth;
      5. the same two keys on the flagship ini raising NotImplementedError
         before any kernel launch, and K3's wrapper so on spectra that
         want a gradient;
      6. `python -m cosmomc_tpu_torch.grid make / run / status` on a
         one-job background grid with one importance rerun (HST added).
    Returns step 2's launch counts and its launches a segment."""
    t_phase = time.time()
    times = {}
    d = os.path.join(tmp, "driver")
    os.makedirs(d)
    launches, per_segment = driver_flagship(dev, d, fid, times)
    driver_background(dev, d, bg, times)
    log(f"phase 13 took {time.time() - t_phase:.1f} s on {smi_line()}: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    return launches, per_segment


def kernel_of(line):
    """The kernel and template arguments of a ptxas "Compiling entry
    function" line: _ZN<len><namespace><len><fn>I{f,d}[Li<NPT>E][Lb<0|1>E
    ...]E...: f float, d double; K1's bool flags are NU, DE."""
    mangled = line.split("'")[1] if "'" in line else "?"
    m = re.search(r"_ZN(\d+)", line)
    n = m and re.match(r"\d+", line[m.end() + int(m.group(1)):])
    if not n:
        return mangled
    i = m.end() + int(m.group(1))
    name = line[i + n.end():i + n.end() + int(n.group())]
    t = re.match(r"I([fd])(?:Li(\d+)E)?((?:Lb[01]E)*)",
                 line[i + n.end() + int(n.group()):])
    if not t:
        return name
    flags = re.findall(r"Lb([01])E", t.group(3))
    return (f"{name} {'f64' if t.group(1) == 'd' else 'f32'}"
            + (f" NPT={t.group(2)}" if t.group(2) else "")
            + "".join(f" {k}={f}" for k, f in zip(("NU", "DE"), flags)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from cosmomc_tpu_torch import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    for name in kernels.SOURCES:
        kernels.load(name)
    log(f"phase 1: built {len(kernels.SOURCES)} kernels in "
        f"{time.time() - t0:.1f} s " + json.dumps(
            {k: round(v, 1) for k, v in kernels.build_seconds.items()}))
    for name, text in kernels.build_log.items():
        kind = "?"
        for line in text.splitlines():
            if "Compiling entry function" in line:
                kind = kernel_of(line)
            elif "registers" in line or "spill stores" in line:
                log(f"  ptxas {name} [{kind}]: {line.split('info    :')[-1].strip()}")

    results = {}
    t0 = time.time()
    phase2(dev, results)
    phase2_matter(dev, results)
    phase2_variants(dev, results)
    log(f"phase 2 done in {time.time() - t0:.1f} s")
    launches, segment = {}, {}
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE)) as tmp:
        for phase, label, cfg in (
                (3, "flagship", {}),
                (4, "lcdm_r", dict(compute_tensors=True,
                                   los_method="recurrence"))):
            t0 = time.time()
            launches[label], segment[label], fid = drive_path(dev, tmp, label,
                                                              cfg)
            if label == "flagship":
                flagship_fid = fid
            log(f"phase {phase} done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["runner"], segment["runner"] = drive_runner(dev, tmp,
                                                             flagship_fid)
        log(f"phase 5 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["background"], bg_sets = drive_background(dev, tmp)
        segment["background"] = dict(launches["background"])
        log(f"phase 6 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["flagship_mp"], segment["flagship_mp"] = drive_matter_power(
            dev, tmp, flagship_fid)
        log(f"phase 7 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["astro"], segment["astro"] = drive_astro(dev, tmp)
        log(f"phase 8 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        sigma8_mnu_anchors(dev)
        launches["mnu"], segment["mnu"] = drive_extended(dev, tmp, "mnu")
        log(f"phase 9 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["w0wa"], segment["w0wa"] = drive_extended(dev, tmp, "w0wa")
        iso_response(dev)
        log(f"phase 10 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["spt"], segment["spt"] = drive_spt(dev, tmp, flagship_fid)
        log(f"phase 11 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["lss_bbn"], segment["lss_bbn"] = drive_lss_bbn(dev, tmp)
        action4_table(flagship_fid["post"])
        log(f"phase 12 done in {time.time() - t0:.1f} s")
        t0 = time.time()
        launches["driver"], segment["driver"] = drive_driver(
            dev, tmp, flagship_fid, bg_sets)
        log(f"phase 13 done in {time.time() - t0:.1f} s")

    rows = []
    for n, (src, rep) in KERNELS.items():
        by_path = {p: launches[p][n] for p in PATH_KERNELS}
        r = results[n]
        log(f"  {n:10s} {r['ms']:9.3f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of it)")
        # library_ms: no single PyTorch call computes any of these functions
        rows.append(dict(name=n, route="cuda", source=src, replaces=rep,
                         launches=sum(by_path.values()),
                         launches_by_path=by_path,
                         launches_per_segment={p: segment[p][n]
                                               for p in PATH_KERNELS},
                         library_ms=None, **r))
    log(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
