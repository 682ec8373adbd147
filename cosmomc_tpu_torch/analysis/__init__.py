"""Chain post-processing: GetDist-compatible statistics and outputs."""

from cosmomc_tpu_torch.analysis.mcsamples import MCSamples, ParamStats  # noqa: F401
