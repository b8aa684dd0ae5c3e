"""Configuration of the PyTorch port: the slice of ``dcfm_tpu.config`` the
port runs, copied (the port imports nothing of ``dcfm_tpu``).

Field names, defaults and meanings are those of the JAX package, so a
config written for one reads the same in the other.  The port runs one
device, one process, the MGP prior with the packed float32 accumulator
fetch; the sweep in float32 or mixed bf16 (``compute_dtype``,
``combine_dtype``), with every ``lambda_kernel``.  Every other knob the
JAX package has is either absent here (passing it is a ``TypeError``) or
present and refused by
:func:`validate` with a ``NotImplementedError`` that names the ROADMAP item
that will port it - a knob is never silently ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ROADMAP items the refusals point at (ROADMAP.md, "Still to port")
_FETCH = "ROADMAP 'Still to port' item 2 (fetch and artifact)"
_CKPT = "ROADMAP 'Still to port' item 3 (pipeline and checkpoint)"
_MESH = "ROADMAP 'Still to port' item 4 (multi-GPU shards)"
_SCEN = "ROADMAP 'Still to port' item 5 (scenarios)"


@dataclasses.dataclass(frozen=True)
class MGPConfig:
    """Multiplicative gamma process prior; rate convention throughout."""

    df: float = 3.0
    ad1: float = 2.0
    bd1: float = 1.0
    ad2: float = 2.0
    bd2: float = 1.0


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
    store_draws: bool = False
    early_stop: str = "off"

    @property
    def total_iters(self) -> int:
        return self.burnin + self.mcmc

    @property
    def num_saved(self) -> int:
        return self.mcmc // self.thin


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """How the chain runs.  The device is an argument of ``fit``."""

    mesh_devices: int = 0
    fetch_dtype: str = "float32"
    upload_dtype: str = "float32"
    fetch_stream: str = "auto"
    compute_dtype: str = "f32"
    sse_mode: str = "resid"


@dataclasses.dataclass(frozen=True)
class FitConfig:
    model: ModelConfig
    run: RunConfig
    backend: BackendConfig = BackendConfig()
    permute: bool = True
    standardize: bool = True
    pad_to_shards: bool = True
    checkpoint_path: Optional[str] = None
    resume: "bool | str" = False


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
    if be.fetch_stream not in ("auto", "on", "off"):
        raise ValueError(
            f"unknown fetch_stream {be.fetch_stream!r} (auto | on | off)")
    if cfg.resume not in (False, True, "auto"):
        raise ValueError(
            f"resume must be False, True, or 'auto', got {cfg.resume!r}")

    # ---- knobs outside the port: refused, never ignored -----------------
    if m.prior != "mgp":
        _refuse(f"prior={m.prior!r}", _SCEN)
    if m.rank_adapt:
        _refuse("rank_adapt=True", _SCEN)
    if m.impute_missing:
        _refuse("impute_missing=True (NaN input)", _SCEN)
    if m.posterior_sd:
        _refuse("posterior_sd=True", _SCEN)
    if run.store_draws:
        _refuse("store_draws=True", _SCEN)
    if run.early_stop != "off":
        _refuse(f"early_stop={run.early_stop!r}", _SCEN)
    if cfg.checkpoint_path or cfg.resume:
        _refuse("checkpoint/resume", _CKPT)
    if be.mesh_devices > 1:
        _refuse(f"mesh_devices={be.mesh_devices}", _MESH)
    if m.combine_chunks != 1:
        _refuse(f"combine_chunks={m.combine_chunks}", _MESH)
    if be.fetch_dtype != "float32":
        _refuse(f"fetch_dtype={be.fetch_dtype!r}", _FETCH)
    if be.fetch_stream == "on":
        _refuse("fetch_stream='on'", _FETCH)
    if be.upload_dtype != "float32":
        _refuse(f"upload_dtype={be.upload_dtype!r}", _FETCH)
