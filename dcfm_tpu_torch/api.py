"""Public API: ``fit`` (config-first) and ``divideconquer`` (reference-shaped).

The port of ``dcfm_tpu/api.py`` for one device and one process.  The flow:
host preprocessing -> the data's upload (``BackendConfig.upload_dtype``)
-> per chain: state init and the Gibbs loop with the packed covariance
accumulator on the device, the chains' accumulators summed in place ->
the fetch (runtime/fetch.py: the chain mean, the padding trim, the
division by the saved-draw count and the link cast under
``BackendConfig.fetch_dtype`` on the device, then a sliced drain into
pinned host memory) -> the native one-pass assembly of Sigma in the
caller's coordinates, zero columns reinserted - or the panels kept packed
(``FitConfig.materialize_sigma``), queried through
:meth:`FitResult.sigma_block` or exported as the serve artifact.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU.  On the card the chain always runs as CUDA graphs of
``RunConfig.sweep_unroll`` sweeps (models/sampler.ChainRunner); the CPU
runs the same trips eagerly.  Float32 matmuls run in full float32: the
sweep's products are numerically load-bearing (the JAX package measured a
prior bias under single-pass reduced precision), so ``fit`` refuses to run
while ``torch.backends.cuda.matmul.allow_tf32`` is on.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from dcfm_tpu_torch.config import (
    _INGEST, BackendConfig, FitConfig, ModelConfig, RunConfig, validate)
from dcfm_tpu_torch.models.priors import make_prior
from dcfm_tpu_torch.models.sampler import (
    TRACE_SUMMARIES, ChainRunner, ChainStats, num_saved_draws)
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.noise import TorchNoise
from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.runtime.fetch import (
    fetch_prep, fetch_upper, quant8_fetch_assemble, quant8_start,
    upload_host_array)
from dcfm_tpu_torch.serve.artifact import PosteriorArtifact, export_fit_result
from dcfm_tpu_torch.utils.diagnostics import ess, split_rhat
from dcfm_tpu_torch.utils.estimate import (
    assemble_from_q8, assemble_from_upper, dequantize_panels,
    full_blocks_from_upper)
from dcfm_tpu_torch.utils.preprocess import PreprocessResult, preprocess

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
    traces: np.ndarray             # (num_chains, iters, 4) chain summaries
    # {"rhat": {summary: float}, "ess": {summary: float}} on the
    # post-burn-in traces; rhat needs num_chains > 1
    diagnostics: dict
    chunk_seconds: list            # wall per chunk, summed over the chains
    # preprocess_s, upload_s, init_s, chain_s (= sum of chunk_seconds),
    # fetch_s (the device prep and the drain), exposed_fetch_s (the part
    # nothing hid: all of it, since the fetch is post hoc), assemble_s
    phase_seconds: dict
    kernel_launches: dict          # hand-written kernel launches in this fit
    graphs: dict                   # unroll, captured, capture_s (inside
                                   # chain_s), replays, eager_trips
    # backing of .upper_panels: float32 panels (every fetch_dtype but
    # quant8), or the int8 panels and their per-panel scales (quant8)
    _upper_f32: Optional[np.ndarray] = None
    _q8_panels: Optional[np.ndarray] = None
    _q8_scales: Optional[np.ndarray] = None

    @functools.cached_property
    def upper_panels(self) -> np.ndarray:
        """(g(g+1)/2, P, P) float32 chain-pooled panels in shard
        coordinates; under quant8 dequantized here on first access."""
        if self._upper_f32 is not None:
            return self._upper_f32
        return dequantize_panels(self._q8_panels, self._q8_scales)

    @functools.cached_property
    def sigma_blocks(self) -> np.ndarray:
        """(g, g, P, P) dense block grid in shard coordinates."""
        return full_blocks_from_upper(self.upper_panels,
                                      self.config.model.num_shards)

    def covariance(self, *, destandardize: bool = True,
                   reinsert_zero_cols: bool = False) -> np.ndarray:
        """The dense covariance from the panels; with both options on it
        is ``Sigma``, bit for bit (under quant8 it is assembled from the
        int8 panels, as Sigma is)."""
        if self._q8_panels is not None:
            return assemble_from_q8(
                self._q8_panels, self._q8_scales, self.preprocess,
                destandardize=destandardize,
                reinsert_zero_cols=reinsert_zero_cols)
        return assemble_from_upper(self.upper_panels, self.preprocess,
                                   destandardize=destandardize,
                                   reinsert_zero_cols=reinsert_zero_cols)

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

    def export_artifact(self, path: str) -> PosteriorArtifact:
        """Write the serve artifact (serve/artifact.py) - int8 panels,
        per-panel scales and the preprocess maps, no dense Sigma - and
        return it opened."""
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


def _copy_state(state: SamplerState) -> SamplerState:
    return SamplerState(*(t.clone() for t in (state.Lambda, state.Z,
                                              state.X, state.ps)),
                        prior={k: v.clone() for k, v in state.prior.items()})


def _stack_states(states: list) -> SamplerState:
    """One state per chain -> the chains' state with a leading chain axis
    (a single chain's state as it is)."""
    if len(states) == 1:
        return states[0]
    return SamplerState(
        *(torch.stack([getattr(s, f) for s in states])
          for f in ("Lambda", "Z", "X", "ps")),
        prior={k: torch.stack([s.prior[k] for s in states])
               for k in states[0].prior})


def _diagnose(traces: np.ndarray, run: RunConfig) -> dict:
    """Split-R-hat (num_chains > 1) and ESS of each trace summary on the
    post-burn-in iterations, as the JAX package reports them."""
    post = traces[:, run.burnin:, :]
    out = {"rhat": {}, "ess": {}}
    if post.shape[1] < 4:
        return out
    for i, name in enumerate(TRACE_SUMMARIES):
        if traces.shape[0] > 1:
            out["rhat"][name] = split_rhat(post[:, :, i])
        out["ess"][name] = ess(post[:, :, i])
    return out


def _refuse_streaming_input(Y) -> None:
    """Sparse and out-of-core inputs, which the JAX package streams
    (``dcfm_tpu/utils/preprocess.is_streaming_input``), are refused by name
    before ``np.asarray`` would densify or mangle them."""
    if (isinstance(Y, np.memmap)
            or (hasattr(Y, "tocsc") and hasattr(Y, "shape"))
            or all(hasattr(Y, a) for a in ("indptr", "indices", "data"))):
        raise NotImplementedError(
            f"sparse and out-of-core inputs ({type(Y).__name__}) are not "
            f"ported to dcfm_tpu_torch yet: {_INGEST}")


def fit(Y: np.ndarray, cfg: FitConfig, *, device="cuda") -> FitResult:
    """Fit the divide-and-conquer Bayesian factor model to (n, p) data on
    ``device``; every draw comes from Philox streams seeded from
    ``cfg.run.seed`` (noise.TorchNoise)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the sweep's "
            "float32 matmuls must run in full float32")
    _refuse_streaming_input(Y)
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise ValueError(f"Y must be an (n, p) matrix, got shape {Y.shape}")
    n, p = Y.shape
    validate(cfg, n, p)
    device = torch.device(device)
    m, run, be = cfg.model, cfg.run, cfg.backend
    # thread the backend's sweep knobs into the internal model config, as
    # the JAX package does
    m = dataclasses.replace(m, sse_mode=be.sse_mode,
                            compute_dtype=be.compute_dtype)
    noise = TorchNoise(run.seed, device)
    launches0 = cuda_lib.launch_counts()
    t_start = time.perf_counter()

    t = time.perf_counter()
    pre = preprocess(Y, m.num_shards, permute=cfg.permute,
                     standardize=cfg.standardize,
                     pad_to_shards=cfg.pad_to_shards, seed=run.seed)
    phase = {"preprocess_s": time.perf_counter() - t}
    want_sigma = (cfg.materialize_sigma == "always"
                  or (cfg.materialize_sigma == "auto"
                      and pre.p_used <= _AUTO_MATERIALIZE_MAX_P))

    t = time.perf_counter()
    Yd = upload_host_array(pre.data, be.upload_dtype).to(device)
    if Yd.dtype != torch.float32:
        Yd = Yd.float()             # the device casts back on arrival
    _sync(device)
    phase["upload_s"] = time.perf_counter() - t

    prior = make_prior(m)
    chunk = run.chunk_size or run.total_iters
    unroll = run.sweep_unroll or (CUDA_AUTO_UNROLL if device.type == "cuda"
                                  else 1)
    runner = ChainRunner(noise, Yd, m, prior, burnin=run.burnin,
                         thin=run.thin, unroll=unroll)
    phase["init_s"] = 0.0
    states, traces, stats, chunk_secs = [], [], [], []
    pooled = None          # the chains' accumulators, summed in chain order
    for c in range(run.num_chains):
        t = time.perf_counter()
        carry = runner.init_chain(c)
        _sync(device)
        phase["init_s"] += time.perf_counter() - t
        chain_traces = []
        for i in range(0, run.total_iters, chunk):
            t = time.perf_counter()
            carry, st, tr = runner.run_chunk(
                c, carry, min(chunk, run.total_iters - i))
            chain_traces.append(tr.cpu().numpy())
            _sync(device)
            if c == 0:
                chunk_secs.append(0.0)
            chunk_secs[i // chunk] += time.perf_counter() - t
        # the runner's carry is the next chain's too: keep copies, except
        # of the last chain
        last = c == run.num_chains - 1
        states.append(carry.state if last else _copy_state(carry.state))
        if pooled is None:
            pooled = carry.sigma_acc if last else carry.sigma_acc.clone()
        else:
            pooled += carry.sigma_acc
        traces.append(np.concatenate(chain_traces, axis=0))
        stats.append(st)
    phase["chain_s"] = float(sum(chunk_secs))
    traces = np.stack(traces)
    state = _stack_states(states)

    # raw sums -> posterior mean on the device (chain mean, padding
    # dropped, times 1/saved draws), the link cast, the drain and the
    # assembly (or not)
    t = time.perf_counter()
    inv_count = np.float32(
        1.0 / max(num_saved_draws(run.total_iters, run.burnin, run.thin), 1))
    g, C, mode = m.num_shards, run.num_chains, be.fetch_dtype
    upper = q8 = scales = Sigma = None
    phase["assemble_s"] = 0.0
    if mode == "quant8":
        started = quant8_start(*fetch_prep(pooled, C, g, inv_count, mode))
        del pooled
        phase["fetch_s"] = time.perf_counter() - t
        Sigma, q8, scales = quant8_fetch_assemble(started, pre, phase,
                                                  assemble=want_sigma)
    else:
        upper = fetch_upper(pooled, C, g, inv_count, mode)
        del pooled
        phase["fetch_s"] = time.perf_counter() - t
        if want_sigma:
            t = time.perf_counter()
            Sigma = assemble_from_upper(upper, pre, reinsert_zero_cols=True)
            phase["assemble_s"] = time.perf_counter() - t
    phase["exposed_fetch_s"] = phase["fetch_s"]

    seconds = time.perf_counter() - t_start
    launches1 = cuda_lib.launch_counts()
    executed = run.total_iters       # once, not once per chain
    return FitResult(
        Sigma=Sigma, preprocess=pre, state=state,
        stats=ChainStats(
            tau_log_max=max(s.tau_log_max for s in stats),
            ps_min=min(s.ps_min for s in stats),
            ps_max=max(s.ps_max for s in stats),
            nonfinite_count=sum(s.nonfinite_count for s in stats),
            acc_nonfinite=sum(s.acc_nonfinite for s in stats)),
        config=cfg, device=str(device), seconds=seconds,
        iters_per_sec=executed / max(seconds, 1e-9),
        chain_iters_per_sec=executed / max(phase["chain_s"], 1e-9),
        traces=traces, diagnostics=_diagnose(traces, run),
        chunk_seconds=chunk_secs, phase_seconds=phase,
        kernel_launches={k: launches1[k] - launches0[k] for k in launches1},
        graphs={"unroll": unroll, "captured": runner.captured,
                "capture_s": runner.capture_s, "replays": runner.replays,
                "eager_trips": runner.eager_trips},
        _upper_f32=upper, _q8_panels=q8, _q8_scales=scales)


def divideconquer(Y: np.ndarray, g: int, k: int, BURNIN: int, MCMC: int,
                  thin: int, rho: float, *, seed: int = 0,
                  prior: str = "mgp", estimator: str = "scaled",
                  x_prior_precision: float = 1.0,
                  device="cuda") -> np.ndarray:
    """Reference-compatible entry point (``divideconquer.m:1``): returns the
    (p, p) posterior-mean covariance in the caller's column order and
    scale, zero rows/cols at all-zero input columns."""
    if k % g != 0:
        raise ValueError(f"k={k} must be divisible by g={g} (K = k/g factors "
                         "per shard)")
    cfg = FitConfig(
        model=ModelConfig(num_shards=g, factors_per_shard=k // g, rho=rho,
                          prior=prior, estimator=estimator,
                          x_prior_precision=x_prior_precision),
        run=RunConfig(burnin=BURNIN, mcmc=MCMC, thin=thin, seed=seed),
        backend=BackendConfig())
    return fit(Y, cfg, device=device).Sigma
