#!/usr/bin/env python3
"""Time the redesigned K4 (recfast) and K1 (Boltzmann RK4) CUDA kernels of
cosmomc_tpu_torch against their first versions, on one card, in turns
(old, new, new, old), at the flagship path's shapes.

    git archive <commit> | tar -x -C _scratch/parent
    python3 scripts/ab_k4_k1.py --parent _scratch/parent

The first versions are the ones with one thread per chain (K4) and one
thread per (chain, k) lane (K1). Their csrc/recfast.cu and
csrc/perturbations.cu are compiled with the same nvcc flags and called
through their own C entry points, whose signatures this script knows
(FIRST_ABI); a tree whose sources declare any other signature, or whose
sources are the current ones, is refused (ab_k3_k2a.build_parent). Both see the same float32
inputs, built as the main path builds them at the best fit: the z table of
8 chains x 8000 nodes, and the stage tables of 8 chains x 248 k on the
8192-step grid (the main path) and the 2048-step grid (where chip_smoke
holds K1 to its plain version); one chain and one (chain, k) lane are timed
as well: what is left of the serial floor. Each time is the mean over
--reps calls by CUDA events, wrapper included; the results of old and new
are compared. Then torch.profiler gives the device time of each new kernel.
Prints one JSON object as the last line.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ab_k3_k2a import build_parent, kernel_name, rel_err  # noqa: E402
from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import perturbations as mpert  # noqa: E402
from cosmomc_tpu_torch.models import recfast as mrec  # noqa: E402
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn  # noqa: E402
from cosmomc_tpu_torch.models.cmb import source_k_grid  # noqa: E402
from cosmomc_tpu_torch.models.reionization import zre_from_tau  # noqa: E402
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization  # noqa: E402

C = 8
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020, tau=0.05430138)
F32, F64 = torch.float32, torch.float64
#: source -> (entry point, its parameters) of the first versions
FIRST_ABI = {
    "recfast.cu": ("recfast_f32", "const void* zt, const void* fhe, const void* kc, "
                   "void* xe, void* tm, int C, int N, void* stream"),
    "perturbations.cu": ("boltzmann_f32", "const void* qtab, const void* kvec, "
                         "const void* rnu, void* out, int C, int S, int nk, "
                         "double rsa_ktau, void* stream"),
}


def timed(fn, reps):
    """Mean milliseconds of `reps` calls after one warm-up call; no result
    is kept alive across calls (the 8192-step output is 455 MB)."""
    fn()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def inputs(dev):
    """The float32 z table and stage tables of the main path at the best fit
    (8 chains, scattered by 0.2%)."""
    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (C, 1))
    for n, v in BESTFIT.items():
        full[:, space.index(n)] = v * (1 + 0.002 * rng.standard_normal(C))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, F64))
    fHe = yhe / (mrec.const.mass_ratio_He_H * (1.0 - yhe))
    Nnow = mrec.const.n_H_today(bg.ombh2, 1.0 / (1.0 - yhe))
    zt = mrec._z_tables(bg, mrec.z_grid(mrec.N_Z, dev, F64), fHe, Nnow)
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    k = torch.as_tensor(source_k_grid(kmax=0.5), dtype=F32, device=dev)
    rnu = mpert._r_nu(bg).float().contiguous()
    qtab = {}
    for n_step in (mpert.N_STEP, 2048):
        tf, _ = mpert.build_thermo_funcs(bg, yhe, th, zre, n_step=n_step)
        qtab[n_step] = mpert._stage_tables(bg, tf).float().contiguous()
    return zt.float().contiguous(), fHe.float().contiguous(), qtab, k, rnu


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree holding the first versions' "
                         "cosmomc_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k4_k1: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    old_rec = build_parent(args.parent, "recfast", "recfast.cu", FIRST_ABI,
                           "ab_k4_k1").recfast_f32
    old_boltz = build_parent(args.parent, "boltzmann", "perturbations.cu",
                             FIRST_ABI, "ab_k4_k1").boltzmann_f32
    kc = torch.tensor(mrec.KERNEL_CONSTS, dtype=F32, device=dev)

    def rec_old(zt, fHe):
        xe = torch.empty(zt.shape[0], zt.shape[2], dtype=zt.dtype, device=dev)
        tm = torch.empty_like(xe)
        kernels.call(old_rec, zt, fHe, kc, xe, tm, zt.shape[0], zt.shape[2])
        return torch.stack([xe, tm])

    def rec_new(zt, fHe):
        return torch.stack(mrec._scan_cuda(zt, fHe))

    def boltz_old(q, k, rnu):
        out = torch.empty(len(mpert.PLANES), q.shape[0], q.shape[1], k.shape[0],
                          dtype=q.dtype, device=dev)
        kernels.call(old_boltz, q, k, rnu, out, q.shape[0], q.shape[1], k.shape[0],
                     float(mpert.RSA_KTAU))
        return out

    def boltz_new(q, k, rnu):
        return mpert._evolve_cuda(q, k, rnu, mpert.RSA_KTAU)

    zt, fHe, qtab, k, rnu = inputs(dev)
    one = lambda t: t[:1].contiguous()
    cases = (
        ("recfast", rec_old, rec_new, (zt, fHe)),
        ("recfast_one_chain", rec_old, rec_new, (one(zt), one(fHe))),
        ("boltzmann_8192", boltz_old, boltz_new, (qtab[mpert.N_STEP], k, rnu)),
        ("boltzmann_2048", boltz_old, boltz_new, (qtab[2048], k, rnu)),
        ("boltzmann_2048_one_lane", boltz_old, boltz_new,
         (one(qtab[2048]), k[-1:].contiguous(), one(rnu))))
    # what the new kernels' data-dependent savings see in these inputs: the
    # prefix K4 does not walk, and the steps whose first table row repeats
    # the row before (there K1 does four RHS evaluations, not five)
    q = qtab[mpert.N_STEP]
    res = {"device": smi, "first_live_node": mrec.first_live_node(zt).tolist(),
           "steps_with_repeated_row": float(
               (q[:, 1:, 0] == q[:, :-1, 2]).all(-1).float().mean())}
    print(json.dumps(res), flush=True)
    for name, old, new, inp in cases:
        err = rel_err(new(*inp), old(*inp))
        ms = {}
        for label, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
            ms.setdefault(label, []).append(timed(lambda: fn(*inp), args.reps))
        res[name] = dict(old_ms=ms["old"], new_ms=ms["new"],
                         speedup=sum(ms["old"]) / sum(ms["new"]),
                         new_vs_old_rel_err=err, reps=args.reps)
        print(f"{name}: old {ms['old']} ms, new {ms['new']} ms, "
              f"speed-up {res[name]['speedup']:.2f}x, new vs old rel err {err:.2e}",
              flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name, _, new, inp in cases:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                new(*inp)
            torch.cuda.synchronize()
        per = {kernel_name(e.key): e.device_time_total / 5e3
               for e in prof.key_averages() if e.device_time_total > 0}
        res[name]["device_ms_by_kernel"] = per
        print(f"{name} device ms by kernel: " + json.dumps(per), flush=True)
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
