"""Public API: ``fit`` (config-first) and ``divideconquer`` (reference-shaped).

The port of ``dcfm_tpu/api.py`` for one device and one process.  The flow:
host preprocessing -> per chain: state init and the Gibbs loop with the
packed covariance accumulator on the device -> division by the saved-draw
count -> the mean over chains -> host assembly into the caller's
coordinates, zero columns reinserted.

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

import numpy as np
import torch

from dcfm_tpu_torch.config import (
    BackendConfig, FitConfig, ModelConfig, RunConfig, validate)
from dcfm_tpu_torch.models.priors import make_prior
from dcfm_tpu_torch.models.sampler import (
    ChainRunner, ChainStats, num_saved_draws)
from dcfm_tpu_torch.models.state import SamplerState, num_upper_pairs
from dcfm_tpu_torch.noise import TorchNoise
from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.utils.estimate import (
    assemble_from_upper, full_blocks_from_upper)
from dcfm_tpu_torch.utils.preprocess import PreprocessResult, preprocess


@dataclasses.dataclass
class FitResult:
    """A completed fit: the posterior mean in the caller's coordinates."""

    Sigma: np.ndarray              # (p, p), zero rows/cols at zero columns
    upper_panels: np.ndarray       # (g(g+1)/2, P, P) chain-pooled panels,
                                   # shard coordinates
    preprocess: PreprocessResult
    state: list                    # final SamplerState of each chain
    stats: ChainStats              # reduced over shards and chains
    config: FitConfig
    device: str
    seconds: float
    iters_per_sec: float           # chain iterations (all chains) / chain_s
    traces: np.ndarray             # (num_chains, iters, 4) chain summaries
    phase_seconds: dict            # preprocess_s, upload_s, init_s,
                                   # chain_s, fetch_s, assemble_s
    kernel_launches: dict          # hand-written kernel launches in this fit
    graphs: dict                   # unroll, captured, capture_s (inside
                                   # chain_s), replays, eager_trips

    @functools.cached_property
    def sigma_blocks(self) -> np.ndarray:
        """(g, g, P, P) dense block grid in shard coordinates."""
        return full_blocks_from_upper(self.upper_panels,
                                      self.config.model.num_shards)


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


def fit(Y: np.ndarray, cfg: FitConfig, *, device="cuda") -> FitResult:
    """Fit the divide-and-conquer Bayesian factor model to (n, p) data on
    ``device``; every draw comes from Philox streams seeded from
    ``cfg.run.seed`` (noise.TorchNoise)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is on: the sweep's "
            "float32 matmuls must run in full float32")
    Y = np.asarray(Y)
    if Y.ndim != 2:
        raise ValueError(f"Y must be an (n, p) matrix, got shape {Y.shape}")
    n, p = Y.shape
    validate(cfg, n, p)
    device = torch.device(device)
    m, run = cfg.model, cfg.run
    # thread the backend's sweep knobs into the internal model config, as
    # the JAX package does
    m = dataclasses.replace(m, sse_mode=cfg.backend.sse_mode,
                            compute_dtype=cfg.backend.compute_dtype)
    noise = TorchNoise(run.seed, device)
    launches0 = cuda_lib.launch_counts()
    t_start = time.perf_counter()

    t = time.perf_counter()
    pre = preprocess(Y, m.num_shards, permute=cfg.permute,
                     standardize=cfg.standardize,
                     pad_to_shards=cfg.pad_to_shards, seed=run.seed)
    phase = {"preprocess_s": time.perf_counter() - t}

    t = time.perf_counter()
    Yd = torch.as_tensor(pre.data, device=device)
    _sync(device)
    phase["upload_s"] = time.perf_counter() - t

    prior = make_prior(m)
    chunk = run.chunk_size or run.total_iters
    unroll = run.sweep_unroll or (CUDA_AUTO_UNROLL if device.type == "cuda"
                                  else 1)
    runner = ChainRunner(noise, Yd, m, prior, burnin=run.burnin,
                         thin=run.thin, unroll=unroll)
    phase["init_s"] = phase["chain_s"] = 0.0
    states, traces, stats = [], [], []
    pooled = None                 # the chains' accumulators, summed in place
    for c in range(run.num_chains):
        t = time.perf_counter()
        carry = runner.init_chain(c)
        _sync(device)
        phase["init_s"] += time.perf_counter() - t
        t = time.perf_counter()
        chain_traces = []
        while carry.iteration < run.total_iters:
            todo = min(chunk, run.total_iters - carry.iteration)
            carry, st, tr = runner.run_chunk(c, carry, todo)
            chain_traces.append(tr.cpu().numpy())
        _sync(device)
        phase["chain_s"] += time.perf_counter() - t
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

    # raw sums -> posterior mean: mean over chains, drop the padding
    # panels, times 1/saved-draws (float32, as the JAX fetch computes it)
    t = time.perf_counter()
    n_saved = num_saved_draws(run.total_iters, run.burnin, run.thin)
    inv_count = np.float32(1.0 / max(n_saved, 1))
    if run.num_chains > 1:
        pooled /= run.num_chains
    upper = (pooled[:num_upper_pairs(m.num_shards)]
             * float(inv_count)).cpu().numpy()
    phase["fetch_s"] = time.perf_counter() - t
    del pooled

    t = time.perf_counter()
    Sigma = assemble_from_upper(upper, pre, reinsert_zero_cols=True)
    phase["assemble_s"] = time.perf_counter() - t

    seconds = time.perf_counter() - t_start
    launches1 = cuda_lib.launch_counts()
    return FitResult(
        Sigma=Sigma, upper_panels=upper, preprocess=pre, state=states,
        stats=ChainStats(
            tau_log_max=max(s.tau_log_max for s in stats),
            ps_min=min(s.ps_min for s in stats),
            ps_max=max(s.ps_max for s in stats),
            nonfinite_count=sum(s.nonfinite_count for s in stats),
            acc_nonfinite=sum(s.acc_nonfinite for s in stats)),
        config=cfg, device=str(device), seconds=seconds,
        iters_per_sec=(run.num_chains * run.total_iters
                       / max(phase["chain_s"], 1e-12)),
        traces=np.stack(traces), phase_seconds=phase,
        kernel_launches={k: launches1[k] - launches0[k] for k in launches1},
        graphs={"unroll": unroll, "captured": runner.captured,
                "capture_s": runner.capture_s, "replays": runner.replays,
                "eager_trips": runner.eager_trips})


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
