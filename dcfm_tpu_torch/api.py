"""Public API: ``fit`` (config-first) and ``divideconquer`` (reference-shaped).

The port of ``dcfm_tpu/api.py`` for one device and one process.  The flow:
host preprocessing -> the data's upload (``BackendConfig.upload_dtype``)
-> the chunk loop (runtime/pipeline.run_chain: the chains' states and
packed covariance accumulators on the device, run chunk-major, with
resume, write-behind checkpoints, the divergence sentinel and, under
quant8, the streamed fetch) -> the fetch (runtime/fetch.py: the chains'
accumulators summed in place, the chain mean, the padding trim, the
division by the saved-draw count and the link cast under
``BackendConfig.fetch_dtype`` on the device, then a sliced drain into
pinned host memory; or the streamed fetch's final snapshot, the same
bits) -> the native one-pass assembly of Sigma in the caller's
coordinates, zero columns reinserted - or the panels kept packed
(``FitConfig.materialize_sigma``), queried through
:meth:`FitResult.sigma_block` or exported as the serve artifact.  Under
``ModelConfig.posterior_sd`` the second-moment sums ride beside the mean's
and the entrywise posterior SD is fetched beside it (``Sigma_sd``); under
``FitConfig.stream_artifact`` the streamed fetch lands its panels in the
serve artifact, which ``fit`` finalizes.  NaN entries of Y are missing
values, imputed every sweep (``FitResult.Y_imputed``); under
``RunConfig.store_draws`` the draw ring comes back as ``FitResult.draws``
(``covariance_credible_interval``); under ``RunConfig.early_stop="rhat"``
the chain stops at the first converged chunk boundary
(``stopped_at_iter``, ``rhat_trajectory``).  ``Y`` may be sparse
(``utils.preprocess.SparseMatrix`` CSR/CSC, a scipy.sparse matrix) or
out of core (``np.memmap``): preprocessing streams it, the upload moves
it block of shards by block of shards, and the panels are bitwise those
of the dense fit of the same data; such a fit keeps Sigma packed unless
``materialize_sigma="always"`` and returns no ``Y_imputed``.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``, or ``BackendConfig.backend="torch_cpu"``;
``"torch_cuda"`` demands the card and never falls back).  Observability:
``FitConfig.obs`` keeps a flight-recorder event log of the fit
(obs/recorder.py; ``FitResult.events_path``), and
``BackendConfig.profile_dir`` wraps the chain in a ``torch.profiler``
trace.  ``FitConfig.warm_start`` seeds the chains from another run's
checkpoint on re-lineaged streams.  On the card the chain always runs as
CUDA graphs of ``RunConfig.sweep_unroll`` sweeps (models/sampler.ChainRunner); the CPU
runs the same trips eagerly.  Float32 matmuls run in full float32: the
sweep's products are numerically load-bearing (the JAX package measured a
prior bias under single-pass reduced precision), so ``fit`` refuses to run
while ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from dcfm_tpu_torch.config import (
    BackendConfig, FitConfig, ModelConfig, RunConfig, validate, validate_obs)
from dcfm_tpu_torch.models.adapt import effective_ranks
from dcfm_tpu_torch.models.priors import make_prior
from dcfm_tpu_torch.models.sampler import (
    TRACE_SUMMARIES, ChainRunner, ChainStats, DrawBuffers)
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.noise import TorchNoise, warm_lineage
from dcfm_tpu_torch.obs import recorder as obs_recorder
from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.resilience.faults import refuse_fit_faults
from dcfm_tpu_torch.runtime.fetch import (
    Drain, accumulator_window, assemble_q8_sigma, elastic_pooled_draws,
    fetch_prep, fetch_sd_prep, fetch_upper, quant8_fetch_assemble,
    quant8_start, upload_data)
from dcfm_tpu_torch.runtime.pipeline import StreamingFetcher, run_chain
from dcfm_tpu_torch.serve.artifact import (
    PosteriorArtifact, begin_streamed_artifact, export_fit_result,
    finalize_streamed_artifact, fit_provenance)
from dcfm_tpu_torch.utils.checkpoint import carry_template, data_fingerprint
from dcfm_tpu_torch.utils.diagnostics import ess, split_rhat
from dcfm_tpu_torch.utils.estimate import (
    assemble_from_q8, assemble_from_upper, dequantize_panels,
    draw_covariance_entries, full_blocks_from_upper)
from dcfm_tpu_torch.utils.preprocess import (
    PreprocessResult, caller_to_shard_index, is_streaming_input, preprocess,
    restore_data_matrix)

# materialize_sigma="auto" assembles the dense (p, p) posterior mean only
# up to this many used columns; past it fit() keeps the packed panels
_AUTO_MATERIALIZE_MAX_P = 100_000


@dataclasses.dataclass
class FitResult:
    """A completed fit: the posterior mean in the caller's coordinates.

    The fields have the JAX package's names and meanings
    (``dcfm_tpu.api.FitResult``), for what the port runs."""

    # (p, p) posterior mean, zero rows/cols at zero columns - or None when
    # the fit kept the panels packed (FitConfig.materialize_sigma): query
    # blocks with .sigma_block or export the serve artifact
    Sigma: Optional[np.ndarray]
    preprocess: PreprocessResult
    state: SamplerState            # final state; leaves gain a leading chain
                                   # axis when num_chains > 1
    stats: ChainStats              # reduced over shards and chains
    config: FitConfig
    device: str
    seconds: float
    iters_per_sec: float           # executed iterations / seconds
    chain_iters_per_sec: float     # executed iterations / chain_s
    traces: np.ndarray             # (num_chains, executed iters, 4) chain
                                   # summaries
    # {"rhat": {summary: float}, "ess": {summary: float}} on the
    # post-burn-in traces; rhat needs num_chains > 1
    diagnostics: dict
    chunk_seconds: list            # wall per chunk, all chains
    # preprocess_s, upload_s, init_s (state init or checkpoint load),
    # chain_s (= sum of chunk_seconds), checkpoint_s (the chain-visible
    # cost of the write-behind saves: snapshot dispatch, joins, the final
    # durability join), fetch_s (the device prep and the drain; streamed:
    # every snapshot's drain), exposed_fetch_s (the part nothing hid: all
    # of a post-hoc fetch, the final join of a streamed one), assemble_s
    phase_seconds: dict
    kernel_launches: dict          # hand-written kernel launches in this fit
    graphs: dict                   # unroll, captured, capture_s (inside
                                   # chain_s), replays, eager_trips
    # repr of a checkpoint save that failed after the chain's last chunk
    # (warned about; the results stand, the run is not resumable from its
    # end), or None
    checkpoint_error: Optional[str] = None
    # divergence-sentinel rewinds this fit performed: > 0 means the chains
    # rewound to a checkpoint on re-lineaged streams with an escalated
    # ridge jitter - a valid chain, not bitwise an undiverged one
    sentinel_rewinds: int = 0
    # the streamed fetch's telemetry, or None when the post-hoc fetch
    # served the result: {"streamed": True, "snapshots", "skipped",
    # "exposed_fetch_s", "chunk_fetch_s", "overlap_fraction"}
    stream_stats: Optional[dict] = None
    # (p, p) entrywise posterior SD of the covariance in the caller's
    # coordinates (ModelConfig.posterior_sd), assembled as Sigma is (None
    # when posterior_sd is off or Sigma is kept packed)
    Sigma_sd: Optional[np.ndarray] = None
    # the serve artifact this fit streamed its panels into
    # (FitConfig.stream_artifact), finalized and openable; else None
    artifact_path: Optional[str] = None
    # the elastic bookkeeping (FitConfig.elastic; checkpoint meta v7) when
    # this fit adopted a checkpoint of another chain count, or resumed a
    # file saved after one: from_chains, to_chains, kept, dropped,
    # birthed, fold_draws, chain_acc_starts, elastic_lineage,
    # from_topology, to_topology; None otherwise
    elastic_resume: Optional[dict] = None
    # the thinned draws (RunConfig.store_draws): {"Lambda": (C, S, g, P,
    # K), "ps": (C, S, g, P), "X": (C, S, n, K), "H": (C, S, g, g, K, K)}
    # in shard coordinates, always chain-major (one chain has a length-1
    # axis); "H" (the per-draw factor cross-moments) under the scaled
    # estimator only; else None
    draws: Optional[dict] = None
    # (n, p) posterior-mean completed data when the input had NaN entries:
    # the caller's values where observed, the mean of the saved draws'
    # imputations (chains pooled) at the NaN positions; else None
    Y_imputed: Optional[np.ndarray] = None
    # the R-hat early stop (RunConfig.early_stop="rhat"): the global
    # iteration the run stopped at (None: it ran its schedule), and the
    # (boundaries, 3) [iteration, max split-R-hat, min pooled ESS] rows it
    # was decided on (None when early_stop is off); Sigma, the traces,
    # the diagnostics and the checkpoint all end at the stop
    stopped_at_iter: Optional[int] = None
    rhat_trajectory: Optional[np.ndarray] = None
    # the flight-recorder run directory of this fit (FitConfig.obs;
    # obs/recorder.py): its append-only JSONL event log - chunk
    # boundaries, stream snapshots and drains, checkpoint saves, sentinel
    # rewinds, the resume and warm-start decisions; None when recording
    # was off
    events_path: Optional[str] = None
    # backing of .upper_panels: float32 panels (every fetch_dtype but
    # quant8), or the int8 panels and their per-panel scales (quant8);
    # the same for .sd_upper_panels
    _upper_f32: Optional[np.ndarray] = None
    _q8_panels: Optional[np.ndarray] = None
    _q8_scales: Optional[np.ndarray] = None
    _sd_upper_f32: Optional[np.ndarray] = None
    _sd_q8_panels: Optional[np.ndarray] = None
    _sd_q8_scales: Optional[np.ndarray] = None

    @functools.cached_property
    def upper_panels(self) -> np.ndarray:
        """(g(g+1)/2, P, P) float32 chain-pooled panels in shard
        coordinates; under quant8 dequantized here on first access."""
        if self._upper_f32 is not None:
            return self._upper_f32
        return dequantize_panels(self._q8_panels, self._q8_scales)

    @functools.cached_property
    def sd_upper_panels(self) -> Optional[np.ndarray]:
        """(g(g+1)/2, P, P) float32 entrywise-SD panels in shard
        coordinates (ModelConfig.posterior_sd), under quant8 dequantized
        here on first access; None when posterior_sd was off."""
        if self._sd_upper_f32 is not None:
            return self._sd_upper_f32
        if self._sd_q8_panels is None:
            return None
        return dequantize_panels(self._sd_q8_panels, self._sd_q8_scales)

    @functools.cached_property
    def sigma_blocks(self) -> np.ndarray:
        """(g, g, P, P) dense block grid in shard coordinates."""
        return full_blocks_from_upper(self.upper_panels,
                                      self.config.model.num_shards)

    @functools.cached_property
    def sigma_sd_blocks(self) -> Optional[np.ndarray]:
        """(g, g, P, P) dense SD block grid in shard coordinates, or
        None."""
        if self.sd_upper_panels is None:
            return None
        return full_blocks_from_upper(self.sd_upper_panels,
                                      self.config.model.num_shards)

    def covariance(self, *, destandardize: bool = True,
                   reinsert_zero_cols: bool = False) -> np.ndarray:
        """The dense covariance from the panels; with both options on it
        is ``Sigma``, bit for bit (under quant8 it is assembled from the
        int8 panels, as Sigma is).  A lazily-ingested fit refuses it
        (``LazyMaterializationError``) unless its config opted in
        (``materialize_sigma="always"``)."""
        force = self.config.materialize_sigma == "always"
        if self._q8_panels is not None:
            return assemble_from_q8(
                self._q8_panels, self._q8_scales, self.preprocess,
                destandardize=destandardize,
                reinsert_zero_cols=reinsert_zero_cols, force=force)
        return assemble_from_upper(self.upper_panels, self.preprocess,
                                   destandardize=destandardize,
                                   reinsert_zero_cols=reinsert_zero_cols,
                                   force=force)

    def posterior_sd(self, *, destandardize: bool = True,
                     reinsert_zero_cols: bool = False) -> np.ndarray:
        """The dense entrywise posterior SD, with :meth:`covariance`'s
        coordinate options (de-standardization scales an SD entry as it
        scales a covariance entry); with both on it is ``Sigma_sd``, bit
        for bit."""
        if self.sd_upper_panels is None:
            raise ValueError("run with ModelConfig(posterior_sd=True)")
        force = self.config.materialize_sigma == "always"
        if self._sd_q8_panels is not None:
            return assemble_from_q8(
                self._sd_q8_panels, self._sd_q8_scales, self.preprocess,
                destandardize=destandardize,
                reinsert_zero_cols=reinsert_zero_cols, force=force)
        return assemble_from_upper(self.sd_upper_panels, self.preprocess,
                                   destandardize=destandardize,
                                   reinsert_zero_cols=reinsert_zero_cols,
                                   force=force)

    def sigma_block(self, i: int, j: int, *,
                    destandardize: bool = True) -> np.ndarray:
        """The (P, P) posterior-mean block of shard pair (i, j) WITHOUT
        the dense (p, p) matrix - the query path of a packed result
        (``Sigma is None``).

        Shard coordinates: rows are shard ``i``'s P columns, columns shard
        ``j``'s (map caller columns with
        ``utils.preprocess.caller_to_shard_index``).  (j, i) is served as
        the transpose of (i, j), diagonal blocks are symmetrized as the
        dense assembly does, and ``destandardize`` scales by the product
        of the two column scales."""
        g = self.config.model.num_shards
        if not (0 <= i < g and 0 <= j < g):
            raise IndexError(f"shard pair ({i}, {j}) out of range for "
                             f"g={g} shards")
        lo, hi = (i, j) if i <= j else (j, i)
        pair = lo * g - lo * (lo - 1) // 2 + (hi - lo)
        block = np.array(self.upper_panels[pair], np.float32, copy=True)
        if i == j:
            block = 0.5 * (block + block.T)
        elif i > j:
            block = np.ascontiguousarray(block.T)
        if destandardize:
            scale = np.asarray(self.preprocess.col_scale, np.float32)
            block *= scale[i][:, None] * scale[j][None, :]
        return block

    def covariance_credible_interval(self, rows, cols, *, alpha=0.05,
                                     destandardize=True) -> tuple:
        """Entrywise equal-tailed (1 - alpha) posterior credible intervals
        of covariance entries from the stored draws (``RunConfig(
        store_draws=True)``), chains pooled: ``(lower, upper)`` shaped like
        ``rows`` / ``cols`` (caller columns, as ``Sigma``'s).  Each draw's
        entry is the estimator's own rule (:func:`draw_covariance_entries`);
        entries of a dropped all-zero column are (0, 0)."""
        if self.draws is None:
            raise ValueError("run with RunConfig(store_draws=True)")
        rows, cols = np.broadcast_arrays(np.asarray(rows, np.int64),
                                         np.asarray(cols, np.int64))
        shape = rows.shape
        rows, cols = rows.reshape(-1), cols.reshape(-1)
        sr = caller_to_shard_index(self.preprocess, rows)
        sc = caller_to_shard_index(self.preprocess, cols)
        valid = (sr >= 0) & (sc >= 0)
        lo = np.zeros(rows.shape, np.float64)
        hi = np.zeros(rows.shape, np.float64)
        if valid.any():
            vals = draw_covariance_entries(self.draws, sr[valid], sc[valid],
                                           rho=self.config.model.rho)
            if destandardize:
                s = np.asarray(self.preprocess.col_scale).reshape(-1)
                vals = vals * (s[sr[valid]] * s[sc[valid]])[None, :]
            q = np.quantile(vals, [alpha / 2, 1.0 - alpha / 2], axis=0)
            lo[valid], hi[valid] = q[0], q[1]
        return lo.reshape(shape), hi.reshape(shape)

    def export_artifact(self, path: str) -> PosteriorArtifact:
        """Write the serve artifact (serve/artifact.py) - int8 panels (and
        SD panels under posterior_sd), per-panel scales and the preprocess
        maps, no dense Sigma - and return it opened.  When the fit already
        streamed its panels into ``path`` (``FitConfig.stream_artifact``)
        the artifact is on disk and this only opens it."""
        if (self.artifact_path is not None
                and os.path.abspath(path)
                == os.path.abspath(self.artifact_path)):
            return PosteriorArtifact.open(path)
        return export_fit_result(self, path)


# RunConfig.sweep_unroll's auto value (0) on the card.  Measured at the
# north-star width (chip_smoke.py's "unroll" lines, PERF.md's findings on
# the graphed chunk): once a trip is one graph replay the host issues
# trips far faster than the card runs them, and T = 1, 2, 4 and 8 sweep
# within 1.5% of each other (T = 2 ~1% the fastest, a saving a 400-sweep
# chain spends again on its dearer warm-up), so auto takes the T with the
# fewest graphs (at most 2 save patterns), the smallest draw buffers and
# the cheapest warm-up.  The CPU takes 1, as the JAX package does
# "elsewhere".
CUDA_AUTO_UNROLL = 1


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack_states(states: list) -> SamplerState:
    """One state per chain -> the chains' state with a leading chain axis
    (a single chain's state as it is)."""
    if len(states) == 1:
        return states[0]
    return SamplerState(
        *(torch.stack([getattr(s, f) for s in states])
          for f in ("Lambda", "Z", "X", "ps")),
        prior={k: torch.stack([s.prior[k] for s in states])
               for k in states[0].prior},
        active=(None if states[0].active is None
                else torch.stack([s.active for s in states])))


def _carried_stats(carries: list) -> ChainStats:
    """The chains' health panels and accumulators as ChainStats: a no-op
    resume ran no chunk to report them."""
    h = torch.stack([c.health for c in carries]).cpu()
    ranks = torch.stack([effective_ranks(c.state) for c in carries]).cpu()
    return ChainStats(
        tau_log_max=float(h[..., 0].max()), ps_min=float(h[..., 1].min()),
        ps_max=float(h[..., 2].max()),
        rank_min=float(ranks.min()), rank_max=float(ranks.max()),
        rank_mean=float(ranks.mean()),
        nonfinite_count=float(h[..., 3].sum()),
        acc_nonfinite=float(sum((~torch.isfinite(c.sigma_acc)).sum()
                                for c in carries)))


def _diagnose(traces: np.ndarray, trace0: int, run: RunConfig) -> dict:
    """Split-R-hat (num_chains > 1) and ESS of each trace summary on the
    post-burn-in iterations, as the JAX package reports them.  The traces
    cover global iterations trace0 + 1 .. total (a resumed fit's start)."""
    post = traces[:, max(run.burnin - trace0, 0):, :]
    out = {"rhat": {}, "ess": {}}
    if post.shape[1] < 4:
        return out
    for i, name in enumerate(TRACE_SUMMARIES):
        if traces.shape[0] > 1:
            out["rhat"][name] = split_rhat(post[:, :, i])
        out["ess"][name] = ess(post[:, :, i])
    return out


def _imputed(Y: np.ndarray, sums: list, pre: PreprocessResult,
             run: RunConfig, end: int, n_saved: int, elastic) -> np.ndarray:
    """``FitResult.Y_imputed`` from the chains' imputation sums, in the
    JAX package's host arithmetic: the chain mean of the sums, divided by
    the window's saved draws (after an elastic adoption, every draw the
    pooled sums hold over the chains), restored to the caller's
    coordinates; the caller's values wherever they were observed."""
    C = len(sums)
    yi = sums[0].cpu().numpy()
    if C > 1:                       # the chains' posterior means, pooled
        yi = np.stack([t.cpu().numpy() for t in sums]).mean(axis=0)
    if elastic is not None:
        total = elastic_pooled_draws(end, run.burnin, run.thin,
                                     elastic.chain_acc_starts,
                                     elastic.fold_draws)
        y_div = max(total, 1) / C
    else:
        y_div = max(n_saved, 1)
    rec = restore_data_matrix(yi / y_div, pre, destandardize=True)
    out = np.array(Y, np.float32, copy=True)
    miss = np.isnan(out)
    out[miss] = rec[miss]
    return out


# BackendConfig.backend -> the device type it runs on (None: the card,
# unless fit's ``device`` asks for the CPU)
_BACKENDS = {"auto": None, "torch_cuda": "cuda", "torch_cpu": "cpu"}


def _resolve_device(backend: BackendConfig, device) -> torch.device:
    """``fit``'s device from ``BackendConfig.backend`` and its ``device``
    argument: "auto" keeps the card unless ``device`` asks for the CPU;
    "torch_cuda" / "torch_cpu" name the device type, and a ``device`` of
    the other type is a ValueError; "torch_cuda" without a card raises
    (no fallback).  The JAX package's values are refused here, where the
    device is resolved - never when a checkpoint's config is read."""
    if backend.backend not in _BACKENDS:
        raise ValueError(
            f"unknown backend {backend.backend!r} (the JAX backends live "
            "in dcfm_tpu; here: auto | torch_cuda | torch_cpu)")
    want = _BACKENDS[backend.backend]
    if device is None:
        device = torch.device(want or "cuda")
    else:
        device = torch.device(device)
        if want is not None and device.type != want:
            raise ValueError(
                f"device={str(device)!r} contradicts "
                f"backend={backend.backend!r}")
    if want == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "backend='torch_cuda' but torch.cuda.is_available() is false "
            "(there is no fallback to the CPU)")
    return device


def _resolve_obs_dir(cfg: FitConfig) -> Optional[str]:
    """FitConfig.obs -> the flight-recorder directory, or None (off):
    "auto" records only where a destination is configured, the
    ``DCFM_OBS_DIR`` environment variable, else ``<checkpoint_path>.obs``
    - so a throwaway fit stays file-free (the JAX package's rule)."""
    validate_obs(cfg.obs)
    if cfg.obs == "off":
        return None
    if cfg.obs != "auto":
        return cfg.obs
    env = os.environ.get(obs_recorder.OBS_DIR_ENV_VAR)
    if env:
        return env
    if cfg.checkpoint_path:
        return cfg.checkpoint_path + ".obs"
    return None


def _profiler(profile_dir: Optional[str], device: torch.device):
    """BackendConfig.profile_dir: a torch.profiler over the chain (CPU
    activity, and CUDA activity on the card) writing its Chrome trace into
    ``profile_dir`` (``tensorboard_trace_handler``); else nothing."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def fit(Y: np.ndarray, cfg: FitConfig, *, device=None) -> FitResult:
    """Fit the divide-and-conquer Bayesian factor model to (n, p) data on
    the device ``BackendConfig.backend`` and ``device`` name
    (:func:`_resolve_device`: the card by default); every draw comes from
    Philox streams seeded from ``cfg.run.seed`` (noise.TorchNoise).  ``Y``
    is a dense array or a streaming input
    (``utils.preprocess.is_streaming_input``).

    With a flight-recorder destination (``FitConfig.obs``) the fit is one
    recorder session: ``fit_start``, the runtime's events, then
    ``fit_failed`` (fsynced) on a raise or ``fit_done`` with the phases,
    the stream summary, rewinds, the checkpoint error and the early stop;
    ``FitResult.events_path`` names the directory.  Recording is
    host-side only: ``obs="off"`` gives the same Sigma bit for bit."""
    obs_dir = _resolve_obs_dir(cfg)
    if obs_dir is None:
        return _fit(Y, cfg, device)
    rec = obs_recorder.install(obs_recorder.FlightRecorder(obs_dir))
    try:
        rec.emit("fit_start", shards=cfg.model.num_shards,
                 factors_per_shard=cfg.model.factors_per_shard,
                 total_iters=cfg.run.total_iters,
                 burnin=cfg.run.burnin, thin=cfg.run.thin,
                 chunk_size=cfg.run.chunk_size, seed=cfg.run.seed,
                 num_chains=cfg.run.num_chains,
                 fetch_dtype=cfg.backend.fetch_dtype,
                 compute_dtype=cfg.backend.compute_dtype,
                 sse_mode=cfg.backend.sse_mode,
                 checkpoint=bool(cfg.checkpoint_path),
                 resume=str(cfg.resume))
        try:
            res = _fit(Y, cfg, device)
        except BaseException as e:
            # a SIGKILL never reaches here - the per-line writes already
            # landed; this covers raised errors
            rec.emit("fit_failed", error=repr(e))
            rec.flush(fsync=True)
            raise
        ph = res.phase_seconds or {}
        rec.emit("fit_done", seconds=round(res.seconds, 4),
                 phases={k: round(v, 4) for k, v in ph.items()},
                 stream=res.stream_stats,
                 sentinel_rewinds=res.sentinel_rewinds,
                 checkpoint_error=res.checkpoint_error,
                 stopped_at_iter=res.stopped_at_iter)
        res.events_path = rec.directory
        return res
    finally:
        obs_recorder.uninstall(rec)
        rec.close()


def _fit(Y: np.ndarray, cfg: FitConfig, device) -> FitResult:
    """The fit body (``fit`` wraps it in the flight-recorder session)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the sweep's "
            "float32 matmuls must run in full float32")
    if is_streaming_input(Y):
        # sparse / out-of-core ingest (utils/preprocess.SparseMatrix,
        # scipy.sparse, np.memmap): never densified here - preprocess
        # streams it column-wise, and the upload holds one block of shards
        # at a time
        if len(Y.shape) != 2:
            raise ValueError(
                f"Y must be an (n, p) matrix, got shape {tuple(Y.shape)}")
        n, p = (int(d) for d in Y.shape)
    else:
        Y = np.asarray(Y)
        if Y.ndim != 2:
            raise ValueError(
                f"Y must be an (n, p) matrix, got shape {Y.shape}")
        n, p = Y.shape
    validate(cfg, n, p)
    refuse_fit_faults()
    device = _resolve_device(cfg.backend, device)
    m, run, be = cfg.model, cfg.run, cfg.backend
    # thread the backend's sweep knobs into the internal model config, as
    # the JAX package does
    m = dataclasses.replace(m, sse_mode=be.sse_mode,
                            compute_dtype=be.compute_dtype)
    launches0 = cuda_lib.launch_counts()
    t_start = time.perf_counter()

    t = time.perf_counter()
    pre = preprocess(Y, m.num_shards, permute=cfg.permute,
                     standardize=cfg.standardize,
                     pad_to_shards=cfg.pad_to_shards, seed=run.seed)
    phase = {"preprocess_s": time.perf_counter() - t}
    if pre.n_missing and not m.impute_missing:
        # NaN entries: the per-sweep imputation, in the internal model
        # only, so the config (and a checkpoint's) round-trips unchanged
        m = dataclasses.replace(m, impute_missing=True)
    S_draws = run.num_saved if run.store_draws else 0
    # a lazily-ingested fit keeps its panels packed unless the config asks
    # for the dense Sigma ("always")
    want_sigma = (cfg.materialize_sigma == "always"
                  or (cfg.materialize_sigma == "auto" and not pre.is_lazy
                      and pre.p_used <= _AUTO_MATERIALIZE_MAX_P))

    t = time.perf_counter()
    Yd = upload_data(pre.data, be.upload_dtype, device)
    _sync(device)
    phase["upload_s"] = time.perf_counter() - t

    unroll = run.sweep_unroll or (CUDA_AUTO_UNROLL if device.type == "cuda"
                                  else 1)
    # a warm start re-lineages the chain's sweep streams (never the init's,
    # so a cold fallback starts from a plain fit's state): the warm chain
    # never replays its donor's draws, and a relaunched warm refit rebuilds
    # the same streams, so it resumes bitwise; a sentinel rewind's lineage
    # extends it
    base = (() if cfg.warm_start is None
            else warm_lineage(cfg.warm_start.relineage))

    def make_runner(model: ModelConfig, lineage: tuple) -> ChainRunner:
        return ChainRunner(TorchNoise(run.seed, device, base + lineage), Yd,
                           model, make_prior(model), burnin=run.burnin,
                           thin=run.thin, unroll=unroll,
                           num_stored_draws=S_draws)

    g, C, mode = m.num_shards, run.num_chains, be.fetch_dtype
    P = pre.data.shape[2]

    def full_window(acc_start: int, elastic, total=None) -> tuple:
        # the one (n_saved, divisor, Bessel factor) of the streamed and
        # the post-hoc fetch, of the window ending at ``total`` (an early
        # stop's iteration; default the schedule's end); ``elastic``:
        # runtime/resume.ElasticResume
        return accumulator_window(
            run.total_iters if total is None else total, run.burnin,
            run.thin, acc_start, C,
            chain_acc_starts=(None if elastic is None
                              else elastic.chain_acc_starts),
            fold_draws=0 if elastic is None else elastic.fold_draws)

    def window(acc_start: int, elastic, total=None) -> tuple:
        return full_window(acc_start, elastic, total)[1:]

    def make_streamer(acc_start: int, elastic) -> StreamingFetcher:
        land_mean = land_sd = None
        if cfg.stream_artifact:
            # land in the serve artifact's panel files (its meta.json is
            # invalidated until the fit finalizes it)
            land_mean, land_sd = begin_streamed_artifact(
                cfg.stream_artifact, g=g, P=P, has_sd=m.posterior_sd)
        inv_count, bessel = window(acc_start, elastic)
        return StreamingFetcher(inv_count, C, g, bessel=bessel,
                                land_mean=land_mean, land_sd=land_sd)

    with _profiler(be.profile_dir, device):
        rr = run_chain(
            cfg=cfg, model=m, run=run, phase=phase,
            fingerprint=(data_fingerprint(pre.data) if cfg.checkpoint_path
                         else None),
            template=carry_template(m, n=n, P=P, num_chains=C,
                                    num_stored_draws=S_draws),
            make_runner=make_runner, device=device, window_fn=window,
            make_streamer=(make_streamer if mode == "quant8"
                           and be.fetch_stream != "off" else None))
    carries, streamer = rr.carries, rr.streamer
    phase["chain_s"] = float(sum(rr.chunk_seconds))
    stats = rr.stats or _carried_stats(carries)
    traces = (np.concatenate(rr.traces, axis=1) if rr.traces
              else np.zeros((C, 0, len(TRACE_SUMMARIES)), np.float32))
    state = _stack_states([c.state for c in carries])
    end = rr.done + rr.executed         # an early stop's iteration too
    n_saved, inv_count, bessel = full_window(rr.acc_start, rr.elastic, end)
    draws = None
    if carries[0].draws is not None:
        # chain-major, one chain included, as the JAX package returns them
        draws = {k: np.stack([getattr(c.draws, k).cpu().numpy()
                              for c in carries])
                 for k in DrawBuffers._fields
                 if getattr(carries[0].draws, k) is not None}
    Y_imputed = None
    # never on a lazy ingest: the completed (n, p) matrix is the dense
    # allocation the streaming path exists to avoid
    if (carries[0].y_imp_acc is not None and pre.n_missing
            and not pre.is_lazy):
        Y_imputed = _imputed(Y, [c.y_imp_acc for c in carries], pre, run,
                             end, n_saved, rr.elastic)

    # raw sums -> posterior mean on the device (chain mean, padding
    # dropped, times 1/saved draws), the link cast, the drain and the
    # assembly (or not) - or, under the streamed fetch, the join of the
    # drain that already landed the final snapshot; the SD beside the
    # mean under posterior_sd
    want_sd = m.posterior_sd
    upper = q8 = scales = Sigma = None
    sd_upper = sd_q8 = sd_scales = Sigma_sd = None
    phase["fetch_s"] = phase["assemble_s"] = 0.0
    stream_stats = streamed = artifact_path = None
    if streamer is not None:
        t = time.perf_counter()
        try:
            streamed = streamer.finish()
            if not streamed["final_landed"]:
                streamed = None
        except Exception as e:  # the reference's policy: warn, fetch post hoc
            warnings.warn(f"streamed accumulator fetch failed ({e!r}); "
                          "falling back to the post-hoc fetch",
                          RuntimeWarning)
        phase["exposed_fetch_s"] = time.perf_counter() - t
    if streamed is not None:
        phase["exposed_fetch_s"] += streamed["final_wait_s"]
        drain = float(sum(streamed["chunk_fetch_s"]))
        phase["fetch_s"] += drain
        stream_stats = {
            "streamed": True, "snapshots": streamed["snapshots"],
            "skipped": streamed["skipped"],
            "exposed_fetch_s": phase["exposed_fetch_s"],
            "chunk_fetch_s": [float(x) for x in streamed["chunk_fetch_s"]],
            "overlap_fraction": (
                max(0.0, min(1.0, 1.0 - phase["exposed_fetch_s"] / drain))
                if drain > 0 else 0.0)}
        q8, scales = streamed["q8"], streamed["scales"]
        sd_q8, sd_scales = streamed["sd_q8"], streamed["sd_scales"]
        if cfg.stream_artifact:
            # the panels landed in the artifact's memmaps: finalize writes
            # the O(p) maps and the metadata (fit -> export is free); the
            # result keeps the artifact's read-only maps, never the
            # writable landing ones
            art = finalize_streamed_artifact(
                cfg.stream_artifact, mean_mm=q8, mean_scale=scales,
                pre=pre, sd_mm=sd_q8, sd_scale=sd_scales,
                provenance=fit_provenance(cfg, "fit-stream"))
            q8, sd_q8 = art.mean_panels, art.sd_panels
            artifact_path = cfg.stream_artifact
        if want_sigma:
            t = time.perf_counter()
            Sigma = assemble_q8_sigma(q8, scales, pre)
            if sd_q8 is not None:
                Sigma_sd = assemble_q8_sigma(sd_q8, sd_scales, pre)
            phase["assemble_s"] = time.perf_counter() - t
    else:
        exposed0 = phase.get("exposed_fetch_s", 0.0)
        t = time.perf_counter()
        pooled = carries[0].sigma_acc   # summed in place, in chain order
        for c in carries[1:]:
            pooled += c.sigma_acc
        pooled_sq = None
        if want_sd:
            pooled_sq = carries[0].sigma_sq_acc
            for c in carries[1:]:
                pooled_sq += c.sigma_sq_acc
        if mode == "quant8":
            q_dev, s_dev = fetch_prep(pooled, C, g, inv_count, mode)
            started = quant8_start(q_dev, s_dev)
            sd_started = None
            if want_sd:
                sd_started = quant8_start(*fetch_sd_prep(
                    pooled_sq, pooled[:q_dev.shape[0]], C, inv_count,
                    bessel, mode))
            del pooled, pooled_sq
            phase["fetch_s"] = time.perf_counter() - t
            Sigma, q8, scales = quant8_fetch_assemble(
                started, pre, phase, assemble=want_sigma)
            if want_sd:
                Sigma_sd, sd_q8, sd_scales = quant8_fetch_assemble(
                    sd_started, pre, phase, assemble=want_sigma)
        else:
            upper = fetch_upper(pooled, C, g, inv_count, mode)
            if want_sd:
                sd_upper = Drain(fetch_sd_prep(
                    pooled_sq, pooled[:upper.shape[0]], C, inv_count,
                    bessel, mode)).wait()
            del pooled, pooled_sq
            phase["fetch_s"] = time.perf_counter() - t
            if want_sigma:
                t = time.perf_counter()
                Sigma = assemble_from_upper(upper, pre,
                                            reinsert_zero_cols=True,
                                            force=True)
                if want_sd:
                    Sigma_sd = assemble_from_upper(sd_upper, pre,
                                                   reinsert_zero_cols=True,
                                                   force=True)
                phase["assemble_s"] = time.perf_counter() - t
        # after a failed stream its join is exposed too
        phase["exposed_fetch_s"] = exposed0 + phase["fetch_s"]
    del carries

    seconds = time.perf_counter() - t_start
    launches1 = cuda_lib.launch_counts()
    executed = rr.executed          # once, not once per chain
    res = FitResult(
        Sigma=Sigma, preprocess=pre, state=state, stats=stats,
        config=cfg, device=str(device), seconds=seconds,
        iters_per_sec=executed / max(seconds, 1e-9),
        chain_iters_per_sec=executed / max(phase["chain_s"], 1e-9),
        traces=traces, diagnostics=_diagnose(traces, rr.trace0, run),
        chunk_seconds=rr.chunk_seconds, phase_seconds=phase,
        kernel_launches={k: launches1[k] - launches0[k] for k in launches1},
        graphs={"unroll": unroll, **rr.graphs},
        checkpoint_error=rr.checkpoint_error,
        sentinel_rewinds=rr.rewinds, stream_stats=stream_stats,
        Sigma_sd=Sigma_sd, artifact_path=artifact_path,
        elastic_resume=(None if rr.elastic is None
                        else dataclasses.asdict(rr.elastic)),
        draws=draws, Y_imputed=Y_imputed,
        stopped_at_iter=rr.stopped_at_iter,
        rhat_trajectory=(None if rr.rhat_trajectory is None
                         else np.asarray(rr.rhat_trajectory, np.float64)),
        _upper_f32=upper, _q8_panels=q8, _q8_scales=scales,
        _sd_upper_f32=sd_upper, _sd_q8_panels=sd_q8,
        _sd_q8_scales=sd_scales)
    if cfg.stream_artifact and res.artifact_path is None:
        # nothing landed (a no-op finished resume, a stream that failed):
        # the post-hoc export, so the artifact exists whenever fit returns
        export_fit_result(res, cfg.stream_artifact)
        res.artifact_path = cfg.stream_artifact
    return res


def divideconquer(Y: np.ndarray, g: int, k: int, BURNIN: int, MCMC: int,
                  thin: int, rho: float, *, backend: str = "auto",
                  seed: int = 0, prior: str = "mgp",
                  estimator: str = "scaled", x_prior_precision: float = 1.0,
                  device=None) -> np.ndarray:
    """Reference-compatible entry point (``divideconquer.m:1``): returns the
    (p, p) posterior-mean covariance in the caller's column order and
    scale, zero rows/cols at all-zero input columns - what ``fit(...)
    .Sigma`` is, so None for a sparse or out-of-core ``Y`` (the packed
    panels are the result there: call ``fit`` and ``sigma_block``)."""
    if k % g != 0:
        raise ValueError(f"k={k} must be divisible by g={g} (K = k/g factors "
                         "per shard)")
    cfg = FitConfig(
        model=ModelConfig(num_shards=g, factors_per_shard=k // g, rho=rho,
                          prior=prior, estimator=estimator,
                          x_prior_precision=x_prior_precision),
        run=RunConfig(burnin=BURNIN, mcmc=MCMC, thin=thin, seed=seed),
        backend=BackendConfig(backend=backend))
    return fit(Y, cfg, device=device).Sigma
