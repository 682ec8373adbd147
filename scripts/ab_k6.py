#!/usr/bin/env python3
"""Time the redesigned K6 (tensor LOS) CUDA kernel of cosmomc_tpu_torch
against its first version, on one card, in turns (old, new, new, old), at
the LCDM+r path's shape.

    git archive c667be0 cosmomc_tpu_torch/csrc | tar -x -C _scratch/parent
    python3 scripts/ab_k6.py --parent _scratch/parent

The first version is the one where one thread owns one (chain, fine k, 4
sampled l) output and reads separate j_l and j_l' tables, 68 l (the 65
sampled l's padded with copies of l = 700 to a multiple of 4). Its
csrc/tensor_los.cu is compiled with the same nvcc flags and called through
its own C entry point, whose signature this script knows (FIRST_ABI); a tree
whose source declares any other signature, or whose source is the current
one, is refused (ab_k3_k2a.build_parent). Both see the same float32 inputs,
built as the main path builds them at the best fit: the tensor sources of 8
chains x 96 k from K5 on the 8192-step grid, 65 sampled l (lmax 700) x 610
fine k x 8192 tau nodes. Each time is the mean over --reps calls by CUDA
events, wrapper included; the results of old and new are compared on the
65 real l's. Then nvidia-smi reads the SM clock while the new kernel runs
alone (every 0.1 s over CLOCK_SECONDS of calls), and torch.profiler gives
the device time of each kernel. It prints the live lattice the new kernel
sees (tensors.tlos_lattice) and one JSON object as the last line.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ab_k2b_k5 import SmClock  # noqa: E402
from ab_k3_k2a import build_parent, kernel_name, rel_err  # noqa: E402
from ab_k4_k1 import timed  # noqa: E402
from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import perturbations as mpert  # noqa: E402
from cosmomc_tpu_torch.models import recfast as mrec  # noqa: E402
from cosmomc_tpu_torch.models import tensors as mten  # noqa: E402
from cosmomc_tpu_torch.models.background import BG_FIELDS  # noqa: E402
from cosmomc_tpu_torch.models.bbn import synthetic_bbn_table, yhe_bbn  # noqa: E402
from cosmomc_tpu_torch.models.bessel import default_l_samples  # noqa: E402
from cosmomc_tpu_torch.models.reionization import zre_from_tau  # noqa: E402
from cosmomc_tpu_torch.params.parameterizations import ThetaParameterization  # noqa: E402

C = 8
LMAX, TAU0_HINT, KMAX_HINT = 700, 14700.0, 0.065
BESTFIT = dict(ombh2=0.02237737, omch2=0.1201035, theta=1.0409020, tau=0.05430138)
F32, F64 = torch.float32, torch.float64
CLOCK_SECONDS = 1.5   # of new calls while the SM clock is read
#: source -> (entry point, its parameters) of the first version
FIRST_ABI = {
    "tensor_los.cu": ("NAME", "const void* src, const void* lo, const void* hi, "
                      "const void* w, const void* kf, const void* chi, const void* wt, "
                      "const void* jl, const void* jlp, const void* ls, void* out, "
                      "int C, int nk, int N, int nl, int nx, int nkf, double inv_dx, "
                      "void* stream"),
}


def inputs(dev):
    """The float32 arguments of K6 on the LCDM+r path at the best fit (8
    chains, scattered by 0.2%): K5's sources on the 8192-step grid."""
    par = ThetaParameterization()
    space = par.default_space()
    rng = np.random.default_rng(1)
    full = np.tile([p.center for p in space.params], (C, 1))
    for n, v in BESTFIT.items():
        full[:, space.index(n)] = v * (1 + 0.002 * rng.standard_normal(C))
    full = torch.as_tensor(full, dtype=F64, device=dev)
    bg = par.to_background(full)
    yhe = yhe_bbn(bg.ombh2, bg.nnu - 3.046, synthetic_bbn_table().to(dev, F64))
    th = mrec.compute_thermo(bg, yhe)
    zre = zre_from_tau(bg, full[:, space.index("tau")], yhe)
    tf, tau0 = mpert.build_thermo_funcs(bg, yhe, th, zre)
    tf32 = tf._replace(**{f: getattr(tf, f).float() for f in tf._fields})
    bg32 = type(bg)(**{f: getattr(bg, f).float() for f in BG_FIELDS},
                    num_massive_nu=bg.num_massive_nu)
    kt = mten.tensor_k_grid()
    to = mten.evolve_tensors(bg32, tf32, tau0.float(),
                             torch.as_tensor(kt, dtype=F32, device=dev))
    args, _ = mten._tlos_inputs(to, LMAX, TAU0_HINT, KMAX_HINT, 4.0, kt)
    return args


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree holding the first version's "
                         "cosmomc_tpu_torch/csrc")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ab_k6: needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    old_fn = build_parent(args.parent, "tensor_los", "tensor_los.cu", FIRST_ABI,
                          "ab_k6").tensor_los_f32
    kernels.load("tensor_los")
    for line in kernels.build_log.get("tensor_los", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("ptxas tensor_los (new): " + line.split("info    :")[-1].strip())

    new_args = inputs(dev)
    src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx = new_args
    nl = ls.shape[0]
    # the first version's 68 l's: the sampled l's padded with copies of the last
    ls_h = default_l_samples(LMAX)
    ls_pad = np.concatenate([ls_h, np.full((-len(ls_h)) % 4, ls_h[-1])])
    pad_tabs = mten.tlos_tables(tuple(ls_pad.tolist()), KMAX_HINT * TAU0_HINT * 1.02 + 10,
                                dev)
    ls_pad_t = torch.as_tensor(ls_pad, dtype=F32, device=dev)

    def old():
        Cn, _, nk, N = src.shape
        nx = pad_tabs["jl"].shape[1]
        out = torch.empty(3, Cn, len(ls_pad), kf.shape[0], dtype=src.dtype, device=dev)
        kernels.call(old_fn, src, lo, hi, w, kf, chi, wt, pad_tabs["jl"], pad_tabs["jlp"],
                     ls_pad_t, out, Cn, nk, N, len(ls_pad), nx, kf.shape[0], inv_dx)
        return out[:, :, :nl]

    def new():
        return mten._tlos_cuda(*new_args)

    tabs = mten._TLOS_BY_TABLE[id(jl)]
    lat = mten.tlos_lattice(chi, kf, tabs["n0"], nl, jl.shape[1], inv_dx)
    res = {"device": smi, "tensor_los_lattice": lat,
           "live_share": lat["live"] / lat["lattice"],
           "walked_share": lat["walked"] / lat["lattice"]}
    print(json.dumps(res), flush=True)
    a, b = new(), old()
    err = rel_err(a, b)
    res["new_vs_old_rel_err"] = err
    res["new_vs_old_rel_err_by_plane"] = [rel_err(a[p], b[p]) for p in range(3)]
    del a, b
    ms = {"old": [], "new": []}
    for label, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        ms[label].append(timed(fn, args.reps))
    res["tensor_los"] = dict(old_ms=ms["old"], new_ms=ms["new"],
                             speedup=sum(ms["old"]) / sum(ms["new"]), reps=args.reps)
    print(f"tensor_los: old {ms['old']} ms, new {ms['new']} ms, speed-up "
          f"{res['tensor_los']['speedup']:.2f}x, new vs old rel err {err:.2e}", flush=True)
    new()
    torch.cuda.synchronize()
    calls = max(1, int(1e3 * CLOCK_SECONDS / min(ms["new"])))
    with SmClock() as clk:
        t = timed(new, calls)
    res["sm_clock_mhz"] = dict(median=statistics.median(clk.mhz), min=min(clk.mhz),
                               max=max(clk.mhz), reads=len(clk.mhz), calls=calls,
                               ms_per_call=t)
    print("SM clock while the new kernel runs: " + json.dumps(res["sm_clock_mhz"]),
          flush=True)
    from torch.profiler import ProfilerActivity, profile
    for label, fn in (("old", old), ("new", new)):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        per = {kernel_name(e.key): e.device_time_total / 5e3
               for e in prof.key_averages() if e.device_time_total > 0}
        res[f"{label}_device_ms_by_kernel"] = per
        print(f"{label} device ms by kernel: " + json.dumps(per), flush=True)
    print(smi)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
