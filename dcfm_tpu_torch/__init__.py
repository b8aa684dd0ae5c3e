"""dcfm_tpu_torch: the PyTorch/CUDA port of dcfm_tpu for one NVIDIA GPU.

The public API mirrors the JAX package's: ``fit(Y, FitConfig)`` and the
reference-shaped ``divideconquer(Y, g, k, burnin, mcmc, thin, rho)``.
Both run on the card by default and take ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.
"""

from dcfm_tpu_torch.api import FitResult, divideconquer, fit
from dcfm_tpu_torch.config import (
    BackendConfig, FitConfig, MGPConfig, ModelConfig, RunConfig)

__all__ = ["BackendConfig", "FitConfig", "FitResult", "MGPConfig",
           "ModelConfig", "RunConfig", "divideconquer", "fit"]
