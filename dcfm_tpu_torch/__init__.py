"""dcfm_tpu_torch: the PyTorch/CUDA port of dcfm_tpu for one NVIDIA GPU.

The public API mirrors the JAX package's: ``fit(Y, FitConfig)`` and the
reference-shaped ``divideconquer(Y, g, k, burnin, mcmc, thin, rho)``.
Both run on the card by default and take ``device="cpu"`` to run the
kernels' plain PyTorch versions instead.  The sparse and out-of-core
ingest is ported: ``Y`` may be a ``utils.preprocess.SparseMatrix`` (CSR
or CSC), a scipy.sparse matrix or an ``np.memmap``, streamed with the JAX
package's semantics (the streaming names live in ``utils.preprocess``, as
in the JAX package), and ``ModelConfig.combine_chunks`` splits the
saved-draw combine on one device.  The serving plane
(``dcfm_tpu_torch.serve``: the query engine on the card, the HTTP server,
the fleet, promotion and deltas) and the command line
(``python -m dcfm_tpu_torch.cli``, ``dcfm-tpu-torch``) are the JAX
package's, over the same artifacts.
"""

from dcfm_tpu_torch.api import FitResult, divideconquer, fit
from dcfm_tpu_torch.config import (
    AdaptConfig, BackendConfig, DLConfig, FitConfig, HorseshoeConfig,
    MGPConfig, ModelConfig, RunConfig)

__all__ = ["AdaptConfig", "BackendConfig", "DLConfig", "FitConfig",
           "FitResult", "HorseshoeConfig", "MGPConfig", "ModelConfig",
           "RunConfig", "divideconquer", "fit"]
