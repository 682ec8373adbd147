"""Build, load and launch the hand-written CUDA kernels under csrc/.

Each kernel source has a plain C interface: `<name>_f32(...)` and
`<name>_f64(...)`, taking device pointers, sizes and a stream, launching on
that stream without synchronising, and returning `cudaGetLastError()`.
At first use the source is compiled by nvcc for sm_90a into a shared
library under `_build/` (keyed by a hash of the sources and flags) and
loaded with ctypes. Nothing here runs at import time.

`launches[name]` counts the launches each wrapper makes: it is raised by
one where the kernel is launched, and nowhere else. A source may hold
several instantiations (`VARIANTS`: K1's massive-neutrino and dark-energy
extensions, and the reverse kernels of K4, K2a, K3, K5 and K6), each with
entry points `<variant>_f32|f64` and a count of its own. A forward kernel
that also stores what its reverse kernel reads is launched through another
entry point of the same kernel (`launch(..., entry=...)`) and counts as
that kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")

#: kernel name -> source file; the sources include the headers csrc/*.cuh
#: (common.cuh; boltzmann_adjoint.cuh in perturbations.cu and
#: boltzmann_bwd.cu), which key the build too. K1's reverse kernel builds
#: once an instantiation (EXTRA_FLAGS), the four in parallel
SOURCES = {
    "recfast": "recfast.cu",          # K4
    "boltzmann": "perturbations.cu",  # K1
    "los": "cls.cu",                  # K2a
    "lensing": "lensing.cu",          # K3
    "los_rec": "los_recurrence.cu",   # K2b
    "tensors": "tensors.cu",          # K5
    "tensor_los": "tensor_los.cu",    # K6
    "boltzmann_bwd": "boltzmann_bwd.cu",        # K1's reverse kernels
    "boltzmann_nu_bwd": "boltzmann_bwd.cu",
    "boltzmann_de_bwd": "boltzmann_bwd.cu",
    "boltzmann_nu_de_bwd": "boltzmann_bwd.cu",
}
#: instantiation -> the kernel (source) that holds it
VARIANTS = {"boltzmann_nu": "boltzmann", "boltzmann_de": "boltzmann",
            "boltzmann_nu_de": "boltzmann", "recfast_bwd": "recfast",
            "los_bwd": "los", "lensing_bwd": "lensing",
            "tensors_bwd": "tensors", "tensor_los_bwd": "tensor_los"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: flags of one source beyond NVCC_FLAGS. K3 rounds every product and sum
#: on its own, as the plain version does (no FMA contraction): its reverse
#: pass's cotangent of C^EE at the top l reads the rounding of the Wigner
#: recurrences, 7.9e-10 of its maximum from autograd of the plain version
#: with contraction on an H100, 7.3e-11 without
#: (scripts/k3_bwd_rounding.py)
EXTRA_FLAGS = {"lensing": ["-fmad=false"],
               "boltzmann_bwd": ["-DK1_NU=0", "-DK1_DE=0"],
               "boltzmann_nu_bwd": ["-DK1_NU=1", "-DK1_DE=0"],
               "boltzmann_de_bwd": ["-DK1_NU=0", "-DK1_DE=1"],
               "boltzmann_nu_de_bwd": ["-DK1_NU=1", "-DK1_DE=1"]}

launches = {name: 0 for name in (*SOURCES, *VARIANTS)}
#: ptxas report (registers, spills) and build seconds of each built kernel
build_log: dict = {}
build_seconds: dict = {}
_libs: dict = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def entry_device(device, what: str) -> torch.device:
    """The device of an entry point: the card unless the caller asks for
    the CPU. Raises when the card is asked for (the default) and there is
    none, so a run never carries on on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} runs on the card by default and no CUDA "
                           "device is available; pass device='cpu' for the "
                           "plain PyTorch versions on the CPU")
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(on PATH or under CUDA_HOME)")


def build(name: str) -> str:
    """Compile csrc/<source> into a shared library (once per content hash of
    the source, the headers and the flags); returns its path."""
    src = os.path.join(CSRC, SOURCES[name])
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, [])
    h = hashlib.sha1(" ".join(flags).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for p in (src, *(os.path.join(CSRC, f) for f in headers)):
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".{os.getpid()}.tmp"
    t0 = time.time()
    res = subprocess.run([_nvcc(), *flags, "-I", CSRC, "-o", tmp, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    build_seconds[name] = time.time() - t0
    build_log[name] = res.stderr
    return out


def load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        _libs[name] = ctypes.CDLL(build(name))
    return _libs[name]


def check(t: torch.Tensor, what: str, shape, dtype=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given shape
    (and dtype, where given; float32 or float64 otherwise)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: the kernel takes CUDA tensors, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)} != {tuple(shape)}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{what}: dtype {t.dtype} != {dtype}")
    if dtype is None and t.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what}: float32 or float64 only, got {t.dtype}")


def launch(name: str, dtype: torch.dtype, *args, entry: str = "") -> None:
    """Call `<entry or name>_f32|f64` (see `call`) of the kernel or
    instantiation `name` and count the launch as `name`'s."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{name}: float32 or float64 only, got {dtype}")
    lib = load(VARIANTS.get(name, name))
    call(getattr(lib, f"{entry or name}_"
                      f"{'f64' if dtype == torch.float64 else 'f32'}"), *args)
    launches[name] += 1


def call(fn, *args) -> None:
    """Call a C entry point with tensors as device pointers, None as a null
    pointer, ints as int and floats as double, plus the current stream;
    raise on a CUDA error."""
    name = fn.__name__
    types, vals, device = [], [], None
    for a in args:
        if torch.is_tensor(a):
            types.append(ctypes.c_void_p)
            vals.append(a.data_ptr())
            device = device or a.device
        elif a is None:
            types.append(ctypes.c_void_p)
            vals.append(None)
        elif isinstance(a, (bool, int)):
            types.append(ctypes.c_int)
            vals.append(int(a))
        elif isinstance(a, float):
            types.append(ctypes.c_double)
            vals.append(a)
        else:
            raise TypeError(f"{name}: unsupported argument {type(a)}")
    types.append(ctypes.c_void_p)
    vals.append(torch.cuda.current_stream(device).cuda_stream)
    fn.argtypes = types
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*vals)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
