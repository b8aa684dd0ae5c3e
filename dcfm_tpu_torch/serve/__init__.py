"""Posterior-serving subsystem: fit once, serve forever - the port's copy
of ``dcfm_tpu/serve``, with the query engine's panel cache on the card.

* :mod:`dcfm_tpu_torch.serve.artifact` - the versioned on-disk format
  (either package opens the other's), export from a ``FitResult`` or a
  checkpoint, ``np.memmap`` open;
* :mod:`dcfm_tpu_torch.serve.engine` - panel-LRU query engine on the
  device, bitwise equal to the offline assembly and to the JAX engine;
* :mod:`dcfm_tpu_torch.serve.batcher` - panel-coalescing microbatcher
  with a bounded queue and explicit backpressure;
* :mod:`dcfm_tpu_torch.serve.server` - stdlib JSON HTTP API with latency
  histograms, cache metrics, tiered load shedding, atomic artifact hot
  swap and graceful SIGTERM drain;
* :mod:`dcfm_tpu_torch.serve.promote` - the ``CURRENT`` promotion
  pointer: CRC-verified atomic publication of a new generation;
* :mod:`dcfm_tpu_torch.serve.delta` - per-panel deltas between
  generations, materialized byte for byte;
* :mod:`dcfm_tpu_torch.serve.fleet` - the supervised ``--workers N``
  SO_REUSEPORT replica fleet;
* :mod:`dcfm_tpu_torch.serve.loadgen` - seeded load generator and
  response classifier.
"""

from dcfm_tpu_torch.serve.artifact import (
    ARTIFACT_VERSION, ArtifactCorruptError, ArtifactError,
    ArtifactVersionError, PosteriorArtifact, create_sparse_artifact,
    export_fit_result, export_from_checkpoint, quantize_panels,
    write_artifact)
from dcfm_tpu_torch.serve.batcher import (
    BatcherClosed, DeadlineExceeded, Overloaded, QueryBatcher)
from dcfm_tpu_torch.serve.engine import PanelCache, QueryEngine
from dcfm_tpu_torch.serve.loadgen import run_load
from dcfm_tpu_torch.serve.promote import (
    POINTER_FILE, PointerError, PointerState, promote_artifact,
    read_pointer, verify_candidate)
from dcfm_tpu_torch.serve.server import GENERATION_HEADER, PosteriorServer

__all__ = [
    "ARTIFACT_VERSION", "ArtifactCorruptError", "ArtifactError",
    "ArtifactVersionError",
    "PosteriorArtifact", "create_sparse_artifact", "export_fit_result",
    "export_from_checkpoint", "quantize_panels", "write_artifact",
    "QueryEngine", "PanelCache", "QueryBatcher", "Overloaded",
    "DeadlineExceeded", "BatcherClosed", "PosteriorServer",
    "GENERATION_HEADER", "POINTER_FILE", "PointerError", "PointerState",
    "promote_artifact", "read_pointer", "verify_candidate", "run_load",
]
