"""cosmomc_tpu_torch: the PyTorch + CUDA port of cosmomc_tpu.

The same theory stack and staged sampler as the JAX package, written with
PyTorch idiom: plain functions on tensors with a leading chains axis,
dataclasses of tensors in place of pytrees, an explicit `device` and
`dtype` everywhere, and `torch.Generator`s for the sampler's randomness.

The hot loops that the JAX package shaped for the TPU (the RECFAST scan,
the Boltzmann RK4, the line-of-sight integral, the lensing recurrences)
are hand-written CUDA kernels under `csrc/`, built with nvcc at first use
(`kernels.py`). Each has a plain PyTorch version in the same module; a
wrapper takes the plain version only for tensors on the CPU.

This package imports neither `jax` nor `cosmomc_tpu`.
"""

__version__ = "0.1.0"
