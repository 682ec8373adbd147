#!/usr/bin/env python3
"""Run chip_smoke.py's checks of the reverse kernels of K1's extended
instantiations (boltzmann_nu_bwd, boltzmann_de_bwd, boltzmann_nu_de_bwd)
without the rest of chip_smoke, on one card:

    python3 scripts/k1_bwd_variants.py

It builds csrc/perturbations.cu and csrc/boltzmann_bwd.cu (one build an
instantiation) and prints ptxas's registers and spills of each reverse
instantiation, writes the reduced-shape inputs
(chip_smoke.ext_reverse_inputs), starts their plain references on the
host CPU (`chip_smoke.py --plain-ref-nu|de|nu-de`, a process of one
thread each) and runs
chip_smoke.phase2_reverse_ext: the timings at the main paths' shapes,
then the comparison with the plain gradients. About five minutes on an
H100, most of it the plain references. It exits non-zero when a check
fails or there is no card.
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
        print("k1_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cosmomc_tpu_torch import kernels
    dev = torch.device("cuda")
    cs.log(cs.smi_line())
    t0 = time.time()
    names = ("boltzmann", *cs.EXT_BWD, "boltzmann_bwd")
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
        vi = cs.ext_reverse_inputs(dev, d)
        jobs = [cs.start_job(m, d) for m in cs.PLAIN_REF_EXT_PARTS]
        try:
            cs.phase2_reverse_ext(dev, results, d, jobs, vi)
        finally:
            for job in jobs:
                if job.poll() is None:
                    job.kill()
                    job.wait()
    cs.log(f"checked in {time.time() - t0:.1f} s on {cs.smi_line()}")
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
