#!/usr/bin/env python3
"""Run chip_smoke.py's checks of the tensor reverse kernels (tensors_bwd,
K5; tensor_los_bwd, K6) without the rest of chip_smoke, on one card:

    python3 scripts/k5_k6_bwd.py

It builds csrc/tensors.cu and csrc/tensor_los.cu, prints ptxas's registers
and spills of each kernel, writes the inputs (chip_smoke.
tensor_reverse_inputs), starts K5's plain reference on the host CPU
(`chip_smoke.py --plain-ref-tensors`, one thread) and runs
chip_smoke.phase2_reverse_tensors: the timings at the main path's shapes,
then the comparisons with the plain gradients. It exits non-zero when a
check fails or there is no card.
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
        print("k5_k6_bwd: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cosmomc_tpu_torch import kernels
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(cs.smi_line())
    t0 = time.time()
    names = ("recfast", "tensors", "tensor_los")
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(kernels.build, names))
    for name in names:
        kernels.load(name)
    cs.log(f"built {names} in {time.time() - t0:.1f} s "
           + json.dumps({k: round(v, 1) for k, v in kernels.build_seconds.items()}))
    for name in names[1:]:
        kind = "?"
        for line in kernels.build_log.get(name, "").splitlines():
            if "Compiling entry function" in line:
                kind = cs.kernel_of(line)
            elif "registers" in line or "spill stores" in line:
                cs.log(f"  ptxas {name} [{kind}]: "
                       f"{line.split('info    :')[-1].strip()}")
    results = {}
    with tempfile.TemporaryDirectory(dir=ROOT) as d:
        t0 = time.time()
        ten = cs.tensor_reverse_inputs(dev, d)
        job = cs.start_job("--plain-ref-tensors", d)
        try:
            cs.phase2_reverse_tensors(dev, results, ten, d, job)
        finally:
            cs.stop_job(job)
    cs.log(f"checked in {time.time() - t0:.1f} s on {cs.smi_line()}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
