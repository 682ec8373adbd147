#!/usr/bin/env python3
"""Time builds of K6 sources that share csrc/tensor_los.cu's C entry point
against each other and against the committed kernel, on one card, in
turns (each build once forward, once backward), at the LCDM+r shape.

    python3 scripts/k6_builds.py a.cu b.cu ...

Each source is compiled with the same nvcc flags as the committed kernels
(it may include csrc/common.cuh) and called through its `tensor_los_f32`
with the arguments `_tlos_cuda` passes, on ab_k6.py's float32 inputs (8
chains at the best fit, 65 l x 610 k x 8192 tau). It prints each build's
registers and spills, whether its result equals the committed kernel's bit
for bit, and, as the last line, one JSON object of the times (ms, the mean
of 10 calls by CUDA events, the launch included).
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

from ab_k3_k2a import rel_err  # noqa: E402
from ab_k4_k1 import timed  # noqa: E402
from ab_k6 import inputs  # noqa: E402
from cosmomc_tpu_torch import kernels  # noqa: E402
from cosmomc_tpu_torch.models import tensors as mten  # noqa: E402


def build(path):
    with open(path, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    out = os.path.join(kernels.BUILD_DIR, f"libk6build_{tag}.so")
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
                          "-o", out, path], capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"k6_builds: nvcc failed for {path}:\n{res.stderr[-3000:]}")
    for line in res.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(os.path.basename(path), line.split("info    :")[-1].strip())
    return ctypes.CDLL(out).tensor_los_f32


def main():
    if not torch.cuda.is_available():
        sys.exit("k6_builds: needs a CUDA device")
    dev = torch.device("cuda")
    fns = {os.path.basename(p): build(p) for p in sys.argv[1:]}
    args = inputs(dev)
    src, lo, hi, w, kf, chi, wt, jl, jlp, ls, inv_dx = args
    tabs = mten._TLOS_BY_TABLE[id(jl)]

    def runner(fn):
        def run():
            C, _, nk, N = src.shape
            out = torch.empty(3, C, ls.shape[0], kf.shape[0], dtype=src.dtype, device=dev)
            kernels.call(fn, src, lo, hi, w, kf, chi, wt, tabs["pairs"], tabs["n0"], ls,
                         out, C, nk, N, ls.shape[0], tabs["pairs"].shape[1], jl.shape[1],
                         kf.shape[0], inv_dx)
            return out
        return run
    runs = {n: runner(f) for n, f in fns.items()}
    runs["committed"] = lambda: mten._tlos_cuda(*args)
    ref = runs["committed"]()
    for n, run in runs.items():
        out = run()
        print(n, "vs committed rel err", rel_err(out, ref), "bit-equal", torch.equal(out, ref))
    names = list(runs)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(timed(runs[n], 10))
    print(json.dumps(ms))


if __name__ == "__main__":
    main()
