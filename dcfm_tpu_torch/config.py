"""Configuration of the PyTorch port: the slice of ``dcfm_tpu.config`` the
port runs, copied (the port imports nothing of ``dcfm_tpu``).

Field names, defaults and meanings are those of the JAX package, so a
config written for one reads the same in the other.  The port runs one
device, one process, the MGP, horseshoe and Dirichlet-Laplace priors
(``prior``) with or without adaptive rank truncation (``rank_adapt``);
the sweep in float32 or mixed bf16
(``compute_dtype``, ``combine_dtype``), with every ``lambda_kernel``; the
accumulator fetch under every ``fetch_dtype`` (post hoc, or streamed at
chunk boundaries under quant8, ``fetch_stream``) and the data upload
under every ``upload_dtype``, with Sigma assembled or kept packed
(``materialize_sigma``); the entrywise posterior SD (``posterior_sd``);
missing values (NaN input, imputed every sweep: ``impute_missing``), the
thinned draw ring (``store_draws``) and the R-hat early stop
(``early_stop``); checkpoints, resume (elastic across chain counts too)
and the divergence sentinel on one process; warm starts from another
run's checkpoint (``warm_start``); the streamed fetch landing in a serve
artifact (``stream_artifact``); the chunked combine on one device
(``combine_chunks``); the flight recorder (``obs``), the profiler trace
(``profile_dir``) and the device switch (``backend``, the port's values
"auto" | "torch_cuda" | "torch_cpu").  Every other knob the JAX package
has is either absent here (passing it is a ``TypeError``) or present and
refused by :func:`validate` with a ``NotImplementedError`` that names the
ROADMAP Queue A item that will port it - a knob is never silently
ignored.  An
invalid value of a refused knob is a ``ValueError`` first, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ROADMAP items the refusals point at (ROADMAP.md, "Queue A")
_MESH = "ROADMAP Queue A item 4 (multi-GPU shards)"
_OUTER = "ROADMAP Queue A item 7 (outer layers)"


@dataclasses.dataclass(frozen=True)
class MGPConfig:
    """Multiplicative gamma process prior; rate convention throughout."""

    df: float = 3.0
    ad1: float = 2.0
    bd1: float = 1.0
    ad2: float = 2.0
    bd2: float = 1.0


@dataclasses.dataclass(frozen=True)
class HorseshoeConfig:
    """Horseshoe prior on the loadings (Makalic & Schmidt 2016 auxiliary
    parameterization: every conditional is inverse-gamma)."""

    global_scale: float = 1.0


@dataclasses.dataclass(frozen=True)
class DLConfig:
    """Dirichlet-Laplace prior (Bhattacharya et al. 2015), row-wise on the
    loadings."""

    a: float = 0.5      # Dirichlet concentration, in (0, 1]


@dataclasses.dataclass(frozen=True)
class AdaptConfig:
    """Adaptive rank truncation (Bhattacharya & Dunson 2011, section 3.2):
    at burn-in iteration t, with probability exp(a0 + a1 t), each shard
    drops the loading columns with at least ``prop`` of their |entries|
    below ``eps`` (never below ``min_active`` columns), or, with none
    redundant, restores its first dropped column.  Columns are masked,
    never removed (``SamplerState.active``)."""

    a0: float = -1.0
    a1: float = -5e-4
    eps: float = 0.05
    prop: float = 0.95
    min_active: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Per shard m: Y_m = Lambda_m eta_m' + eps, eps ~ N(0, diag(1/ps_m)),
    eta_m = sqrt(rho) X + sqrt(1 - rho) Z_m with X shared across shards."""

    num_shards: int
    factors_per_shard: int
    rho: float
    prior: str = "mgp"
    x_prior_precision: float = 1.0
    estimator: str = "scaled"            # "scaled" | "plain"
    as_: float = 1.0
    bs: float = 0.3
    posterior_sd: bool = False
    combine_dtype: str = "float32"      # "float32" | "bfloat16"
    # internal mirrors of BackendConfig.compute_dtype / sse_mode (fit()
    # threads the backend knobs here, as the JAX package does)
    compute_dtype: str = "f32"
    sse_mode: str = "resid"              # "resid" | "gram" | "auto"
    # The Lambda update's kernel, chosen as in the JAX package: "pallas-
    # fused" runs the fused update K2 and "pallas" the factor-solve-sample
    # K1 (both K <= 16); every other value runs K4 under compute_dtype
    # "bf16" and K1 otherwise, with torch.linalg for K > 16.  On the CPU
    # each kernel runs its plain PyTorch version.
    lambda_kernel: str = "auto"  # auto | unrolled | lax | pallas | pallas-fused
    rank_adapt: bool = False
    impute_missing: bool = False
    combine_chunks: int = 1
    ridge_jitter: float = 0.0
    mgp: MGPConfig = MGPConfig()
    horseshoe: HorseshoeConfig = HorseshoeConfig()
    dl: DLConfig = DLConfig()
    adapt: AdaptConfig = AdaptConfig()

    @property
    def total_factors(self) -> int:
        return self.num_shards * self.factors_per_shard


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Chain schedule (the reference's BURNIN/MCMC/thin arguments)."""

    burnin: int
    mcmc: int
    thin: int = 1
    seed: int = 0
    # host-level chunking of the chain loop (0 = one chunk); chunking never
    # changes the chain - every draw is keyed on the global iteration
    chunk_size: int = 0
    num_chains: int = 1
    # sweeps per trip of the chain (0 = auto): on the card one trip is one
    # CUDA graph replay; results are identical for every value (every
    # iteration keeps its own draws, save condition and trace row).  Auto
    # is api.CUDA_AUTO_UNROLL on the card and 1 on the CPU
    sweep_unroll: int = 0
    # keep every thinned post-burn-in draw of (Lambda, ps, X) and, under
    # the scaled estimator, the factor cross-moments H on the device
    # (FitResult.draws, covariance_credible_interval)
    store_draws: bool = False
    # "rhat": stop at the first chunk boundary with chunks left where the
    # worst trace summary's split-R-hat < rhat_threshold and its pooled
    # ESS >= ess_target (runtime/pipeline.early_stop_metrics)
    early_stop: str = "off"
    rhat_threshold: float = 1.01
    ess_target: float = 400.0

    @property
    def total_iters(self) -> int:
        return self.burnin + self.mcmc

    @property
    def num_saved(self) -> int:
        return self.mcmc // self.thin


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """How the chain runs, in the JAX package's field order (a checkpoint's
    config JSON lists them in it)."""

    # "auto" (the card unless fit's ``device`` asks for the CPU) |
    # "torch_cuda" | "torch_cpu"; resolved by api.fit, which refuses the
    # JAX package's values ("jax_cpu", "jax_tpu") there - never when a
    # checkpoint's config is read
    backend: str = "auto"
    mesh_devices: int = 0
    fetch_dtype: str = "float32"
    upload_dtype: str = "float32"
    # if set, fit() wraps the chain in a torch.profiler trace (CPU
    # activity, and CUDA activity on the card) and writes its Chrome trace
    # here; the per-conditional record_function ranges (z_update,
    # x_update, lambda_update, prior_update, ps_update, combine,
    # health_trace, impute_missing) mark the eager sweeps, one "trip"
    # range each CUDA-graph replay
    profile_dir: Optional[str] = None
    fetch_stream: str = "auto"
    compute_dtype: str = "f32"
    sse_mode: str = "resid"


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Seed a fresh chain from a prior run's checkpoint (the JAX package's
    online loop; runtime/resume._try_warm_start): the donor's sampler
    state is grafted into the new run's initial state - appended rows and
    new shards keep their fresh init in the grown region - and the chain's
    streams are re-lineaged by ``relineage``, so the warm chain never
    replays the donor's draws.  Either package's file may be the donor.
    An incompatible or unreadable donor falls back to a cold start,
    recorded as a ``warm_start`` flight-recorder event with the reason."""

    checkpoint: str
    relineage: int = 1


@dataclasses.dataclass(frozen=True)
class FitConfig:
    model: ModelConfig
    run: RunConfig
    backend: BackendConfig = BackendConfig()
    permute: bool = True
    standardize: bool = True
    pad_to_shards: bool = True
    # chunk-boundary checkpoints of the chains (utils/checkpoint.py) and
    # resume from them (runtime/resume.py): False | True (a compatible
    # file is required) | "auto" (fall back to a fresh start)
    checkpoint_path: Optional[str] = None
    resume: "bool | str" = False
    # may a full checkpoint written at a different chain count be adopted
    # (runtime/resume._try_elastic: a shrink folds the dropped chains'
    # sums into chain 0, a grow births chains on a fresh lineage)?  True
    # and "auto" adopt it; False refuses the file as incompatible
    elastic: "bool | str" = "auto"
    # save every k-th chunk boundary (the last always saves); "auto"
    # starts at 1 and re-sizes from the latest save's measured seconds
    # (runtime/pipeline.auto_cadence)
    checkpoint_every_chunks: "int | str" = "auto"
    # "full": the whole carry (exact resume); "light": the sampler state
    # only (MBs), a resume restarts the accumulator at the saved iteration
    checkpoint_mode: str = "full"
    # light mode: every k-th due save is full, into checkpoint_path +
    # ".full" (the sidecar resume prefers when it keeps more draws)
    checkpoint_full_every: int = 0
    # the live file plus keep_last - 1 rotated ``.bakK`` generations
    checkpoint_keep_last: int = 1
    # divergence sentinel (resilience/sentinel.py): "rewind" to the last
    # good checkpoint, "abort" with ChainDivergedError, "auto" (rewind
    # with a checkpoint, abort without), or "off"
    sentinel: str = "auto"
    sentinel_max_rewinds: int = 3
    # the flight recorder (obs/recorder.py): "auto" records when a
    # destination is configured - the DCFM_OBS_DIR environment variable,
    # else "<checkpoint_path>.obs" - "off" never, any other string into
    # that directory (FitResult.events_path)
    obs: str = "auto"
    # a serve artifact directory the streamed quant8 fetch lands its
    # panels in (serve/artifact.begin_streamed_artifact); fit finalizes
    # it, or exports post hoc when nothing landed
    stream_artifact: Optional[str] = None
    # seed this run's chains from another run's checkpoint state; resume
    # takes precedence (a relaunched warm refit resumes its own file)
    warm_start: Optional[WarmStart] = None
    # the dense (p, p) posterior mean: "always", "never" (FitResult.Sigma
    # is None; blocks through FitResult.sigma_block, or the serve
    # artifact), or "auto" - assembled up to api._AUTO_MATERIALIZE_MAX_P
    # used columns
    materialize_sigma: str = "auto"


def validate_obs(obs) -> None:
    """The obs knob's check, shared by :func:`validate` and
    ``api._resolve_obs_dir`` (which runs first, at recorder setup)."""
    if not isinstance(obs, str) or not obs:
        raise ValueError(
            f"obs must be 'auto', 'off', or a directory path, got "
            f"{obs!r}")


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(
        f"{what} is not ported to dcfm_tpu_torch yet: {item}")


def validate(cfg: FitConfig, n: int, p: int) -> None:
    """The JAX package's checks for the fields the port reads, then the
    refusals of every knob outside the port."""
    m, run, be = cfg.model, cfg.run, cfg.backend
    if m.num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {m.num_shards}")
    if m.factors_per_shard < 1:
        raise ValueError(
            f"factors_per_shard must be >= 1, got {m.factors_per_shard}")
    if not 0.0 <= m.rho <= 1.0:
        raise ValueError(f"rho must be in [0, 1], got {m.rho}")
    if not cfg.pad_to_shards and p % m.num_shards != 0:
        raise ValueError(
            f"p={p} not divisible by g={m.num_shards} and pad_to_shards=False")
    if run.burnin < 0 or run.mcmc < 0:
        raise ValueError("burnin and mcmc must be >= 0")
    if run.total_iters < 1:
        raise ValueError("burnin + mcmc must be >= 1")
    if run.thin < 1:
        raise ValueError(f"thin must be >= 1, got {run.thin}")
    if run.num_chains < 1:
        raise ValueError(f"num_chains must be >= 1, got {run.num_chains}")
    if run.mcmc % run.thin != 0:
        raise ValueError("mcmc must be divisible by thin")
    if run.chunk_size < 0:
        raise ValueError(f"chunk_size must be >= 0, got {run.chunk_size}")
    if run.sweep_unroll < 0:
        raise ValueError(
            f"sweep_unroll must be >= 0 (0 = auto), got {run.sweep_unroll}")
    if m.estimator not in ("plain", "scaled"):
        raise ValueError(
            f"unknown estimator {m.estimator!r} (expected 'plain' or "
            "'scaled')")
    if m.lambda_kernel not in ("auto", "unrolled", "lax", "pallas",
                               "pallas-fused"):
        raise ValueError(
            f"unknown lambda_kernel {m.lambda_kernel!r} "
            "(auto | unrolled | lax | pallas | pallas-fused)")
    if m.lambda_kernel.startswith("pallas") and m.factors_per_shard > 16:
        raise ValueError(
            f"lambda_kernel={m.lambda_kernel!r} supports factors_per_shard "
            f"<= 16, got {m.factors_per_shard}; use lambda_kernel='auto'")
    if m.combine_dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"unknown combine_dtype {m.combine_dtype!r} (float32 | bfloat16)")
    if m.ridge_jitter < 0:
        raise ValueError(f"ridge_jitter must be >= 0, got {m.ridge_jitter}")
    for name, mode in (("BackendConfig.sse_mode", be.sse_mode),
                       ("ModelConfig.sse_mode", m.sse_mode)):
        if mode not in ("resid", "gram", "auto"):
            raise ValueError(
                f"unknown {name} {mode!r} (resid | gram | auto)")
    for name, dt in (("BackendConfig.compute_dtype", be.compute_dtype),
                     ("ModelConfig.compute_dtype", m.compute_dtype)):
        if dt not in ("f32", "bf16"):
            raise ValueError(f"unknown {name} {dt!r} (f32 | bf16)")
    if be.fetch_dtype not in ("float32", "bfloat16", "float16", "quant8"):
        raise ValueError(
            f"unknown fetch_dtype {be.fetch_dtype!r} "
            "(float32 | bfloat16 | float16 | quant8)")
    if be.upload_dtype not in ("float32", "float16", "bfloat16"):
        raise ValueError(
            f"unknown upload_dtype {be.upload_dtype!r} "
            "(float32 | float16 | bfloat16)")
    if be.fetch_stream not in ("auto", "on", "off"):
        raise ValueError(
            f"unknown fetch_stream {be.fetch_stream!r} (auto | on | off)")
    if be.fetch_stream == "on" and be.fetch_dtype != "quant8":
        raise ValueError(
            "fetch_stream='on' requires fetch_dtype='quant8': the "
            "streamed double buffer lands int8 panels (use fetch_stream="
            "'auto', which simply does not engage for other dtypes)")
    if cfg.stream_artifact is not None:
        if be.fetch_dtype != "quant8":
            raise ValueError(
                "stream_artifact requires fetch_dtype='quant8' (the "
                "artifact layout is the int8 panel set)")
        if be.fetch_stream == "off":
            raise ValueError(
                "stream_artifact requires the streamed fetch "
                "(fetch_stream 'auto' or 'on', not 'off')")
    if cfg.warm_start is not None:
        ws = cfg.warm_start
        if not isinstance(ws.checkpoint, str) or not ws.checkpoint:
            raise ValueError(
                "warm_start.checkpoint must be a non-empty path to the "
                "donor run's checkpoint")
        if not isinstance(ws.relineage, int) or ws.relineage < 1:
            raise ValueError(
                f"warm_start.relineage must be an int >= 1, got "
                f"{ws.relineage!r} (0 would replay the donor's streams)")
    if be.fetch_dtype == "float16" and not cfg.standardize:
        raise ValueError(
            "fetch_dtype='float16' requires standardize=True: raw-scale "
            "covariance entries can exceed float16's 65504 max and would "
            "silently saturate to inf (bfloat16 keeps float32 range, "
            "quant8's per-panel scale adapts to any range)")
    if be.upload_dtype == "float16" and not cfg.standardize:
        raise ValueError(
            "upload_dtype='float16' requires standardize=True: raw-scale "
            "data entries can exceed float16's 65504 max and would reach "
            "the sampler as inf (bfloat16 keeps float32 range)")
    if cfg.materialize_sigma not in ("auto", "always", "never"):
        raise ValueError(
            f"unknown materialize_sigma {cfg.materialize_sigma!r} "
            "(auto | always | never)")
    if cfg.resume not in (False, True, "auto"):
        raise ValueError(
            f"resume must be False, True, or 'auto', got {cfg.resume!r}")
    if cfg.resume and not cfg.checkpoint_path:
        raise ValueError("resume requires checkpoint_path")
    if cfg.elastic not in (False, True, "auto"):
        raise ValueError(
            f"elastic must be False, True, or 'auto', got {cfg.elastic!r}")
    cek = cfg.checkpoint_every_chunks
    if not (cek == "auto" or (isinstance(cek, int) and cek >= 1)):
        raise ValueError(
            f"checkpoint_every_chunks must be >= 1 or 'auto', got {cek!r}")
    if cfg.checkpoint_mode not in ("full", "light"):
        raise ValueError(
            f"unknown checkpoint_mode {cfg.checkpoint_mode!r} "
            "(full | light)")
    if cfg.checkpoint_full_every < 0:
        raise ValueError(
            f"checkpoint_full_every must be >= 0, got "
            f"{cfg.checkpoint_full_every}")
    if cfg.checkpoint_keep_last < 1:
        raise ValueError(
            f"checkpoint_keep_last must be >= 1, got "
            f"{cfg.checkpoint_keep_last}")
    if cfg.sentinel not in ("auto", "off", "abort", "rewind"):
        raise ValueError(
            f"unknown sentinel mode {cfg.sentinel!r} "
            "(auto | off | abort | rewind)")
    if cfg.sentinel == "rewind" and not cfg.checkpoint_path:
        raise ValueError(
            "sentinel='rewind' requires checkpoint_path (there is nothing "
            "to rewind to); use 'abort', or 'auto' which degrades itself")
    if cfg.sentinel_max_rewinds < 0:
        raise ValueError(
            f"sentinel_max_rewinds must be >= 0, got "
            f"{cfg.sentinel_max_rewinds}")
    validate_obs(cfg.obs)
    # value checks of the scenario knobs and of those refused below, as
    # the JAX package makes them: an invalid value of a refused knob is a
    # ValueError, never "not ported yet"
    if m.prior not in ("mgp", "horseshoe", "dl"):
        raise ValueError(f"unknown prior {m.prior!r}")
    if run.early_stop not in ("off", "rhat"):
        raise ValueError(
            f"unknown early_stop {run.early_stop!r} (off | rhat)")
    if run.store_draws and run.num_saved < 1:
        raise ValueError(
            "store_draws=True but the schedule saves no draws "
            f"(mcmc={run.mcmc}, thin={run.thin})")
    if run.early_stop == "rhat":
        if run.num_chains < 2:
            raise ValueError(
                "early_stop='rhat' requires num_chains >= 2 "
                "(split-R-hat is undefined on one chain)")
        if run.chunk_size < 1:
            raise ValueError(
                "early_stop='rhat' requires chunk_size >= 1: the stop is "
                "a chunk-boundary decision, and chunk_size=0 runs the "
                "whole schedule in one chunk with no boundaries")
        if run.store_draws:
            raise ValueError(
                "early_stop='rhat' is incompatible with store_draws: the "
                "draw ring is statically sized by the full schedule and a "
                "truncated run would return zero-padded draws")
        if not (run.rhat_threshold > 1.0):
            raise ValueError(
                f"rhat_threshold must be > 1.0, got {run.rhat_threshold}")
        if not (run.ess_target > 0):
            raise ValueError(
                f"ess_target must be > 0, got {run.ess_target}")
    if m.combine_chunks < 1 or m.num_shards % m.combine_chunks != 0:
        raise ValueError(
            f"combine_chunks={m.combine_chunks} must be >= 1 and divide "
            f"num_shards={m.num_shards}")
    if m.rank_adapt:
        a = m.adapt
        if a.a1 >= 0:
            raise ValueError(
                f"adapt.a1={a.a1} must be < 0 (adaptation probability "
                "exp(a0 + a1*t) must decay, Bhattacharya-Dunson condition)")
        if not 0.0 < a.prop <= 1.0:
            raise ValueError(f"adapt.prop={a.prop} must be in (0, 1]")
        if a.eps <= 0:
            raise ValueError(f"adapt.eps={a.eps} must be > 0")
        if not 1 <= a.min_active <= m.factors_per_shard:
            raise ValueError(
                f"adapt.min_active={a.min_active} must be in "
                f"[1, factors_per_shard={m.factors_per_shard}]")
    if m.prior == "dl" and not 0.0 < m.dl.a <= 1.0:
        raise ValueError(
            f"DL concentration a={m.dl.a} must be in (0, 1] "
            "(1/K <= a <= 1/2 is the usual range)")

    # ---- knobs outside the port: refused, never ignored -----------------
    if be.mesh_devices > 1:
        _refuse(f"mesh_devices={be.mesh_devices}", _MESH)
