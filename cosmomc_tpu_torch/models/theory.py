"""Theory products consumed by likelihoods (port of
cosmomc_tpu/models/theory.py, CMB part): a NamedTuple of per-chain tensors
in place of the TCosmoTheoryPredictions pytree."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cosmomc_tpu_torch.models.background import (BackgroundFunctions,
                                                 BackgroundParams)


class CMBTheoryProducts(NamedTuple):
    bg: BackgroundParams
    bf: BackgroundFunctions
    rs_drag: torch.Tensor                 # (C,)
    #: (C, 4, 4, lmax+1) TEBP stack, l(l+1)C_l/2pi muK^2; PP [l(l+1)]^2 C/2pi
    cls: Optional[torch.Tensor] = None
