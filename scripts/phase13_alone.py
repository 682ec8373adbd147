#!/usr/bin/env python3
"""Run chip_smoke.py's phase 13 (the ini driver) and its boltzmann_nu_de
check without the rest of chip_smoke, on one card:

    python3 scripts/phase13_alone.py

It builds the seven kernels, holds K1's boltzmann_nu_de to its plain
version (chip_smoke.phase2_nu_de), then makes what phase 13 reads: phase
3's flagship run (its plik_lite fiducial and float64 theory), phase 5's
DR12-shaped BAO set and phase 6's background sets, and runs
chip_smoke.drive_driver. About four minutes on an H100, most of it the
nu_de plain version and the first flagship theory pass of each new
process (the line-of-sight Bessel table, built on the host). It exits
non-zero when a check fails or there is no card.
"""

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("phase13_alone: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cosmomc_tpu_torch import kernels
    dev = torch.device("cuda")
    cs.log(cs.smi_line())
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(kernels.SOURCES)) as pool:
        list(pool.map(kernels.build, kernels.SOURCES))
    for name in kernels.SOURCES:
        kernels.load(name)
    cs.log(f"built in {time.time() - t0:.1f} s")
    results = {}
    t0 = time.time()
    cs.phase2_nu_de(dev, results)
    cs.log(f"boltzmann_nu_de checked in {time.time() - t0:.1f} s: "
           + json.dumps(results["boltzmann_nu_de"]))
    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        t0 = time.time()
        _, _, fid = cs.drive_path(dev, tmp, "flagship", {})
        cs.flagship_dr12(dev, tmp, fid)
        bg = cs.background_sets(dev, tmp)
        cs.log(f"phase 13's inputs in {time.time() - t0:.1f} s")
        cli = cs.flagship_cli_runs(dev, os.path.join(tmp, "driver"), fid)
        launches, per_segment = cs.drive_driver(dev, tmp, fid, bg, cli)
    cs.log(json.dumps({"launches": launches, "per_segment": per_segment}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
