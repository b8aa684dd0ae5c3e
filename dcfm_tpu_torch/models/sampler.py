"""Chain driver: Gibbs sweeps in trips of ``unroll``, captured as CUDA
graphs on the card, with on-device accumulation of the packed
posterior-mean covariance panels.

The port of ``init_chain`` / ``run_chunk`` in ``dcfm_tpu/models/sampler.py``,
where one ``lax.scan`` runs a chunk, ``RunConfig.sweep_unroll`` sweeps to a
compiled loop trip.  Here a chunk is a sequence of trips of ``unroll``
sweeps plus one shorter remainder trip (trips never cross a chunk
boundary).  On the card a trip is a CUDA graph, captured once per
(trip length, save pattern) and replayed once per trip; on the CPU the
same trip code runs eagerly.  Either way the chain is the one a loop of
single sweeps gives: every draw of iteration ``it`` comes from
``noise.sweep(chain, it)``, keyed on the chain's global index and the
global iteration (drawn ahead of each trip, outside any graph:
noise.BufferedDraws), and every iteration keeps its own save condition and
trace row.  Nothing inside a chunk reads a device value on the host: the
save cadence is host arithmetic, and health and trace stay on the device
until the chunk ends.

Under ``ModelConfig.impute_missing`` each sweep first completes the data
(``impute_missing_y``, from the static Y and its static NaN mask) and runs
on the completed matrix, which saved draws also sum into ``y_imp_acc``;
under ``RunConfig.store_draws`` saved draws are written into the draw ring
(``DrawBuffers``) at a slot computed on the device from the iteration
tensor ``ChainRunner._its``, never from a Python int a capture would bake
in.  A saved draw's panels are formed and added range by range of the
packed-pair axis (``ModelConfig.combine_chunks``; :func:`add_panels`): on
the card a float32 range is one launch of the combine kernel, which keeps
no panel in device memory; the bf16 combine's temporary is one range's.
On the shard mesh (``ChainRunner(..., mesh=)``, parallel/shard.py) the
runner holds the rank's block of shards and packed panels, draws its
slice of the one-device chain's variates (noise.ShardSliceNoise), sums the
X update's and the trace's shard sums through the mesh's all-reduce, and
reads a saved draw's loadings, residual precisions and factors through
its all-gather - inside the graphs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from typing import NamedTuple, Optional

import torch

from dcfm_tpu_torch.analysis.registry import TraceSpec, register_trace_entry
from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.adapt import adapt_rank, effective_ranks
from dcfm_tpu_torch.models.conditionals import (
    cross_moments, gibbs_sweep, impute_missing_y, local_sum, mm_bf16,
    trace_data)
from dcfm_tpu_torch.models.state import (
    SamplerState, init_state, num_padded_pairs, packed_pair_indices)
from dcfm_tpu_torch.noise import (
    BufferedDraws, RecordingDraws, ShardSliceNoise, TorchNoise, draw_into)
from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.ops.combine import combine_panels, combine_panels_plain
from dcfm_tpu_torch.profiling import (
    StageClock, StageTally, recording, scope)

# per-iteration chain summaries, in the JAX package's order: mean signal
# variance, mean residual variance, their sum, average log-likelihood
TRACE_SUMMARIES = ("signal_var_mean", "resid_var_mean", "sigma_diag_mean",
                   "avg_loglik")


class DrawBuffers(NamedTuple):
    """The thinned post-burn-in draws of one chain (RunConfig.store_draws):
    ring slot s holds saved draw s, as in the JAX package's DrawBuffers.
    ``H`` holds each draw's factor cross-moments eta_r' eta_c / n under
    the scaled estimator (None under "plain"): with it a draw's covariance
    entry is exactly the scaled rule's (utils/estimate.
    draw_covariance_entries)."""
    Lambda: torch.Tensor            # (S, G, P, K)
    ps: torch.Tensor                # (S, G, P)
    X: torch.Tensor                 # (S, n, K)
    H: Optional[torch.Tensor] = None    # (S, G, G, K, K)


@dataclasses.dataclass
class ChainCarry:
    state: SamplerState
    sigma_acc: torch.Tensor   # (Q, P, P) packed running SUM of the upper
                              # Sigma panels over saved draws (divided by
                              # num_saved_draws at fetch)
    iteration: int            # global Gibbs iterations done
    health: torch.Tensor      # (G, 4) running [max |log tau|, min ps,
                              # max ps, #iterations with non-finite state]
    # (Q, P, P) packed running SUM of the panels' squares over saved draws
    # (ModelConfig.posterior_sd: the entrywise second moment), else None
    sigma_sq_acc: Optional[torch.Tensor] = None
    # the draw ring (RunConfig.store_draws), else None
    draws: Optional[DrawBuffers] = None
    # (G, n, P) running SUM over saved draws of the completed data matrix
    # (ModelConfig.impute_missing), else None
    y_imp_acc: Optional[torch.Tensor] = None
    # CUDA events of copies that still read these tensors on a side
    # stream (a checkpoint snapshot, a streamed-fetch sum): whatever writes
    # the carry next waits for them first (wait_readers)
    readers: list = dataclasses.field(default_factory=list)


def draw_leaves(draws: Optional[DrawBuffers]) -> list:
    """The ring's tensors in the JAX DrawBuffers' order (none without a
    ring; no H under the plain estimator)."""
    return [] if draws is None else [t for t in draws if t is not None]


def carry_tensors(carry: ChainCarry) -> list:
    """The carry's tensors in the JAX ChainCarry's order: the state's
    leaves, the accumulator, health, then where present the second
    moment, the draw ring and the imputation sum."""
    opt = [] if carry.sigma_sq_acc is None else [carry.sigma_sq_acc]
    opt += draw_leaves(carry.draws)
    opt += [] if carry.y_imp_acc is None else [carry.y_imp_acc]
    return [*state_leaves(carry.state), carry.sigma_acc, carry.health, *opt]


def carry_shard_axes(carry: ChainCarry) -> list:
    """Per tensor of :func:`carry_tensors`, the axis the shard mesh splits
    it along (parallel/shard.py): the shard axis of the per-shard leaves,
    the packed-pair axis of the accumulators, axis 1 of the draw ring's
    per-shard leaves, None for X (every rank of a chain holds it whole)."""
    st = carry.state
    axes = [0, 0, None, 0, *([0] * len(st.prior)),
            *([] if st.active is None else [0]), 0, 0]
    axes += [] if carry.sigma_sq_acc is None else [0]
    if carry.draws is not None:
        axes += [ax for ax, t in zip((1, 1, None, 1), carry.draws)
                 if t is not None]
    axes += [] if carry.y_imp_acc is None else [0]
    return axes


def carry_like(carry: ChainCarry, tensors: list) -> ChainCarry:
    """A carry of ``carry``'s structure and iteration holding ``tensors``
    (in :func:`carry_tensors`' order)."""
    it = iter(tensors)
    st = carry.state
    state = SamplerState(
        Lambda=next(it), Z=next(it), X=next(it), ps=next(it),
        prior={k: next(it) for k in sorted(st.prior)},
        active=None if st.active is None else next(it))
    acc, health = next(it), next(it)
    sq = None if carry.sigma_sq_acc is None else next(it)
    draws = None
    if carry.draws is not None:
        draws = DrawBuffers(*(None if t is None else next(it)
                              for t in carry.draws))
    y_imp = None if carry.y_imp_acc is None else next(it)
    return ChainCarry(state=state, sigma_acc=acc, iteration=carry.iteration,
                      health=health, sigma_sq_acc=sq, draws=draws,
                      y_imp_acc=y_imp)


def wait_readers(carry: ChainCarry, stream) -> None:
    """Make ``stream`` wait for every side-stream copy still reading
    ``carry``, before it writes the carry (a CPU carry has no readers)."""
    for ev in carry.readers:
        stream.wait_event(ev)
    carry.readers.clear()


class ChainStats(NamedTuple):
    """Numerical-health diagnostics over every iteration seen."""
    tau_log_max: float
    ps_min: float
    ps_max: float
    # effective rank (active loading columns per shard) at chunk end:
    # factors_per_shard unless adaptive truncation pruned columns
    rank_min: float
    rank_max: float
    rank_mean: float
    # (iteration, shard) pairs whose post-sweep state held a non-finite
    # value (a failed K x K Cholesky propagates NaN); 0 on a healthy chain
    nonfinite_count: float
    # non-finite entries of the accumulator at chunk end
    acc_nonfinite: float


def num_saved_draws(iteration: int, burnin: int, thin: int) -> int:
    """Saved draws after ``iteration`` global iterations."""
    return max(0, int(iteration) - burnin) // thin


def _health_now(state: SamplerState, prior) -> torch.Tensor:
    shrink_log = prior.health(state.prior)                      # (G,)
    ok = (torch.isfinite(state.Lambda).all(dim=2).all(dim=1)
          & torch.isfinite(state.ps).all(dim=1)
          & torch.isfinite(state.X).all()
          & torch.isfinite(shrink_log))
    bad = (~ok).to(state.ps.dtype)
    return torch.stack([shrink_log, state.ps.amin(dim=-1),
                        state.ps.amax(dim=-1), bad], dim=-1)


def _health_update(running: torch.Tensor, now: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.maximum(running[:, 0], now[:, 0]),
                        torch.minimum(running[:, 1], now[:, 1]),
                        torch.maximum(running[:, 2], now[:, 2]),
                        running[:, 3] + now[:, 3]], dim=-1)


def _trace_now(state: SamplerState, sse: torch.Tensor, rho: float,
               reduce_fn=local_sum,
               num_global_shards: Optional[int] = None) -> torch.Tensor:
    """(4,) summaries of one sweep's output, from the (G, P) SSE the psi
    stage already formed (no data-sized contraction), summed over all
    ``num_global_shards`` shards of the chain by one ``reduce_fn`` (the
    sweep's; an all-reduce on the shard mesh)."""
    G, P = state.ps.shape
    n = state.X.shape[0]
    p_total = (num_global_shards or G) * P
    eta = math.sqrt(rho) * state.X[None] + math.sqrt(1.0 - rho) * state.Z
    E = torch.einsum("gnk,gnj->gkj", eta, eta) / n
    M = torch.einsum("gpk,gkj->gpj", state.Lambda, E)
    sig_j = torch.sum(M * state.Lambda, dim=-1)                 # (G, P)
    loglik = 0.5 * torch.sum(
        n * (torch.log(state.ps) - math.log(2.0 * math.pi))
        - state.ps * sse, dim=-1)                               # (G,)
    signal, rvar, ll = reduce_fn(torch.stack(
        [torch.sum(sig_j, dim=-1), torch.sum(1.0 / state.ps, dim=1),
         loglik], dim=-1))
    return torch.stack([signal / p_total, rvar / p_total,
                        (signal + rvar) / p_total, ll / (p_total * n)])


_STREAMS: dict = {}     # device index -> the runners' stream


def _runner_stream(device: torch.device):
    """One side stream per card for every runner: PyTorch keeps a cuBLAS
    workspace per (handle, stream) for the life of the process, so a new
    stream per fit would leave one behind each time."""
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


def _health_init(G: int, device) -> torch.Tensor:
    return torch.tensor([0.0, math.inf, 0.0, 0.0], dtype=torch.float32,
                        device=device).expand(G, 4).clone()


def init_chain(draws, Y: torch.Tensor, cfg: ModelConfig, prior,
               num_stored_draws: int = 0, *,
               num_local_pairs: Optional[int] = None,
               num_global_shards: Optional[int] = None) -> ChainCarry:
    """Initial state, zero packed accumulators, a fresh health panel and,
    where configured, a zero draw ring of ``num_stored_draws`` slots
    (RunConfig.num_saved under store_draws) and a zero imputation sum.
    On the shard mesh ``Y`` is the rank's block of shards, the
    accumulators its ``num_local_pairs`` packed panels and the ring's H
    its rows of the ``num_global_shards`` x ``num_global_shards`` grid."""
    G, n, P = Y.shape
    G_all = num_global_shards or G
    K = cfg.factors_per_shard
    state = init_state(draws, prior, G=G, n=n, P=P, K=K, as_=cfg.as_,
                       bs=cfg.bs, device=Y.device,
                       rank_adapt=cfg.rank_adapt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=Y.device)

    acc = zeros(num_local_pairs or num_padded_pairs(G), P, P)
    S = num_stored_draws
    ring = None
    if S:
        ring = DrawBuffers(
            Lambda=zeros(S, G, P, K), ps=zeros(S, G, P), X=zeros(S, n, K),
            H=(zeros(S, G, G_all, K, K) if cfg.estimator == "scaled"
               else None))
    return ChainCarry(state=state, sigma_acc=acc, iteration=0,
                      health=_health_init(G, Y.device),
                      sigma_sq_acc=(torch.zeros_like(acc)
                                    if cfg.posterior_sd else None),
                      draws=ring,
                      y_imp_acc=zeros(G, n, P) if cfg.impute_missing
                      else None)


def state_leaves(state: SamplerState) -> list:
    """The state's tensors in the JAX SamplerState's flatten order: the
    prior's by name, then the column mask under rank adaptation."""
    return [state.Lambda, state.Z, state.X, state.ps,
            *(state.prior[k] for k in sorted(state.prior)),
            *([] if state.active is None else [state.active])]


def save_pattern(start: int, length: int, burnin: int,
                 thin: int) -> tuple:
    """The save conditions of the ``length`` iterations after ``start``
    global iterations: iteration ``it`` (1-based, as the JAX chain's
    ``save``) accumulates when it > burnin and (it - burnin) % thin == 0."""
    return tuple(it > burnin and (it - burnin) % thin == 0
                 for it in range(start + 1, start + length + 1))


def trip_lengths(num_iters: int, unroll: int) -> list:
    """A chunk's trips: ``unroll`` sweeps each, then the remainder."""
    full, rest = divmod(num_iters, unroll)
    return [unroll] * full + ([rest] if rest else [])


def pair_chunks(Q: int, chunks: int) -> list:
    """The chunked combine's split of the packed-pair axis of length ``Q``
    into ``chunks`` contiguous ranges (c0, c1) at (i * Q) // chunks, the
    JAX package's bounds (ModelConfig.combine_chunks)."""
    bounds = [(i * Q) // chunks for i in range(chunks + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def add_panels(sigma_acc: torch.Tensor, sigma_sq_acc: Optional[torch.Tensor],
               state: SamplerState, rho: float, rows: torch.Tensor,
               cols: torch.Tensor, chunks: list, *,
               eta: Optional[torch.Tensor] = None,
               H_grid: Optional[torch.Tensor] = None,
               compute_dtype: Optional[torch.dtype] = None) -> None:
    """A saved draw's packed panels added to the accumulators in place,
    range by range of ``chunks`` (:func:`pair_chunks`): the panels of pairs
    [c0, c1) added into ``sigma_acc[c0:c1]`` (and their squares into
    ``sigma_sq_acc``) - the single-device body of the JAX package's
    chunked combine.  The ranges are Python ints, fixed in every captured
    graph; the JAX package's mesh rendezvous token has no counterpart on
    one device.

    A float32 combine is one :func:`~dcfm_tpu_torch.ops.combine.
    combine_panels` a range (on the card the combine kernel, which forms
    each panel in registers: no temporary).  The bf16 combine
    (``compute_dtype=torch.bfloat16``) is other arithmetic - bf16-rounded
    inputs and intermediate - and keeps its GEMMs (the plain version with
    :func:`mm_bf16`) and a range's (c1 - c0, P, P) temporary."""
    if eta is not None and H_grid is None:
        H_grid = cross_moments(eta)
    H = None if eta is None else H_grid
    for c0, c1 in chunks:
        sq = None if sigma_sq_acc is None else sigma_sq_acc[c0:c1]
        args = (sigma_acc[c0:c1], sq, state.Lambda, state.ps, rows[c0:c1],
                cols[c0:c1])
        if compute_dtype is None:
            combine_panels(*args, rho=rho, H_grid=H)
        else:
            combine_panels_plain(*args, rho, H, mm=mm_bf16)


class _Graph(NamedTuple):
    """A captured trip: its graph, the launches it counts, its replays'
    profiler range, and its stage timer (a timed twin's) or None."""
    graph: object
    tally: dict
    span: str
    clock: Optional[StageClock]


class ChainRunner:
    """Runs the chains of one fit on ``Y`` in trips of ``unroll`` sweeps.

    ``graphs`` (default: whether Y is on the card) makes each trip a CUDA
    graph: a (length, save pattern) is run eagerly the first time it is
    met, on the real chain (the warm-up), captured the second time and
    replayed from then on.  A capture advances nothing and counts no
    launch; each replay adds the launches its capture counted
    (cuda_lib.capture_tally).  All graphs share one memory pool and replay
    serially on the runner's stream, which also runs the eager trips and
    the draws.  ``num_stored_draws`` sizes the draw ring (0: none).
    ``graphs=False`` on the card is the eager chain the card
    tests and chip_smoke.py hold the graphs against; a failed capture or
    replay raises, never falls back to it.

    The graphs read and write one static carry, the runner's, in place.
    A chain either runs on it directly (:meth:`init_chain` resets it to
    chain c's initial state; the card tests and chip_smoke.py drive one
    chain that way) or keeps a carry of its own (:meth:`new_chain`), which
    :meth:`run_chunk` copies into the static carry on the runner's stream,
    advances there and copies back out - so ``fit`` runs its chains
    chunk-major, all of them at the same global iteration at every chunk
    boundary, and nothing is recaptured.  Graphs, draw slots and the
    static carry are the runner's: it lives for one fit, or until a
    sentinel rewind changes the model (its jitter is baked into the
    graphs).

    While a profiler records, each trip's steps are ranges (profiling.py:
    ``api.chain.draw``, ``.eager``, ``.capture``, ``.replay.save`` /
    ``.replay.plain``, and a chunk's ``api.chain.boundary``), and each
    pattern's first trip in a chunk replays a twin of its graph whose
    stage boundaries are timing events (profiling.StageClock), captured
    beside it; the chunk's end adds those samples, and the GIG sampler's
    counts the twin carries, to ``stages``
    (profiling.StageTally).  Every other replay is the untimed graph, the
    graph a fit with no profiler replays.
    """

    def __init__(self, noise, Y: torch.Tensor, cfg: ModelConfig, prior, *,
                 burnin: int, thin: int, unroll: int = 1, graphs=None,
                 num_stored_draws: int = 0, mesh=None):
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        cuda = Y.device.type == "cuda"
        self.use_graphs = cuda if graphs is None else bool(graphs)
        if self.use_graphs and not cuda:
            raise ValueError("CUDA graphs need Y on a CUDA device")
        # the shard mesh (parallel/shard.RankMesh): Y is the rank's block
        # of shards, the X update's and the trace's sums all-reduce over
        # the chain's ranks, a saved draw's combine reads the all-gathered
        # loadings and the accumulators hold the rank's packed panels
        self.mesh = mesh
        if mesh is None:
            rows, cols = packed_pair_indices(Y.shape[0])
            self._reduce, self._gather = local_sum, None
            self._g_all, self._off = Y.shape[0], 0
        else:
            rows, cols = mesh.pair_rows, mesh.pair_cols
            self._reduce, self._gather = mesh.reduce_fn, mesh.gather_fn
            self._g_all, self._off = mesh.num_shards, mesh.shard_offset
            noise = ShardSliceNoise(noise, self._off, Y.shape[0],
                                    self._g_all)
        self.noise, self.Y, self.cfg, self.prior = noise, Y, cfg, prior
        self.burnin, self.thin, self.unroll = burnin, thin, unroll
        self.num_stored_draws = num_stored_draws
        self._rows = torch.as_tensor(rows, dtype=torch.long, device=Y.device)
        self._cols = torch.as_tensor(cols, dtype=torch.long, device=Y.device)
        # the chunked combine's ranges of the packed-pair axis
        # (ModelConfig.combine_chunks; one range when it is 1)
        self._pair_chunks = pair_chunks(rows.size, cfg.combine_chunks)
        # the combine's input dtype: the combine_dtype knob, or the
        # sweep-wide bf16 policy; the accumulator stays float32 either way
        self._c_dtype = (torch.bfloat16 if (cfg.combine_dtype == "bfloat16"
                                            or cfg.compute_dtype == "bf16")
                         else None)
        self._stream = _runner_stream(Y.device) if cuda else None
        self._pool = (torch.cuda.graph_pool_handle() if self.use_graphs
                      else None)
        self._trace = torch.empty((unroll, len(TRACE_SUMMARIES)),
                                  dtype=torch.float32, device=Y.device)
        # rank adaptation and the draw ring's slot read each sweep's
        # 1-based global iteration: a device tensor written before every
        # trip, never a constant baked into a capture
        self._its = (torch.zeros((unroll,), dtype=torch.float32,
                                 device=Y.device)
                     if cfg.rank_adapt or num_stored_draws else None)
        # the missing entries, once: every sweep completes the static Y
        self._mask = torch.isnan(Y) if cfg.impute_missing else None
        self.carry = None
        self._recipe = None        # the sweep's draw calls, recorded once
        self._slots = None         # per call: (unroll, *shape) variates
        self._seen: set = set()    # save patterns run at least once
        self._graphs: dict = {}    # save pattern -> _Graph
        # under a profiler: save pattern -> its twin with timing events,
        # replayed for the pattern's first trip in each chunk (_sampled)
        self._timed: dict = {}
        self._sampled: set = set()
        self.captured, self.capture_s = 0, 0.0
        self.replays = self.eager_trips = 0
        self.stages = StageTally()

    @contextlib.contextmanager
    def _on_stream(self):
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.Y.device)
        self._stream.wait_stream(caller)
        with torch.cuda.stream(self._stream):
            yield
        caller.wait_stream(self._stream)

    def init_chain(self, chain: int) -> ChainCarry:
        """Reset the static carry to chain ``chain``'s initial state (the
        first call creates it) and return it."""
        if self.carry is None:
            self.carry = self._init(self.noise.init(chain))
            return self.carry
        G, n, P = self.Y.shape
        state = init_state(self.noise.init(chain), self.prior, G=G, n=n,
                           P=P, K=self.cfg.factors_per_shard,
                           as_=self.cfg.as_, bs=self.cfg.bs,
                           device=self.Y.device,
                           rank_adapt=self.cfg.rank_adapt)
        for dst, src in zip(state_leaves(self.carry.state),
                            state_leaves(state), strict=True):
            dst.copy_(src)
        self.carry.sigma_acc.zero_()
        for t in ([self.carry.sigma_sq_acc, self.carry.y_imp_acc]
                  + draw_leaves(self.carry.draws)):
            if t is not None:
                t.zero_()
        self.carry.health.copy_(_health_init(G, self.Y.device))
        self.carry.iteration = 0
        return self.carry

    def new_chain(self, chain: int, lineage: int = 0) -> ChainCarry:
        """Chain ``chain``'s initial carry in tensors of its own (the
        static carry's values after ``init_chain(chain)``); ``lineage`` > 0
        draws it on a fresh lineage (an elastic birth)."""
        draws = (self.noise.init(chain, lineage) if lineage
                 else self.noise.init(chain))
        return self._init(draws)

    def _init(self, draws) -> ChainCarry:
        return init_chain(draws, self.Y, self.cfg, self.prior,
                          self.num_stored_draws,
                          num_local_pairs=int(self._rows.shape[0]),
                          num_global_shards=self._g_all)

    def run_chunk(self, chain: int, carry: ChainCarry, num_iters: int
                  ) -> tuple[ChainCarry, ChainStats, torch.Tensor]:
        """Run ``num_iters`` Gibbs iterations of chain ``chain`` on
        ``carry``: the runner's static carry in place, or a chain's own
        carry (:meth:`new_chain`) copied into the static one, advanced and
        copied back, once whatever still reads it is done.

        On every thin-th post-burn-in iteration the packed Sigma panels of
        the draw are ADDED to the accumulator, and under posterior_sd their
        squares to the second-moment accumulator (raw sums; the caller
        divides by :func:`num_saved_draws`).  Returns (carry, stats, trace) with
        trace (num_iters, 4) on the device."""
        own = carry is not self.carry
        trace = torch.empty((num_iters, len(TRACE_SUMMARIES)),
                            dtype=torch.float32, device=self.Y.device)
        with self._on_stream():
            if own:
                self._load(carry)
            work = self.carry
            pos = 0
            for length in trip_lengths(num_iters, self.unroll):
                self._trip(chain, work.iteration, save_pattern(
                    work.iteration, length, self.burnin, self.thin),
                    trace[pos:pos + length])
                work.iteration += length
                pos += length
            with scope("api.chain.boundary"):
                h = work.health.cpu()
                ranks = effective_ranks(work.state).cpu()
                stats = ChainStats(
                    tau_log_max=float(h[:, 0].max()),
                    ps_min=float(h[:, 1].min()), ps_max=float(h[:, 2].max()),
                    rank_min=float(ranks.min()), rank_max=float(ranks.max()),
                    rank_mean=float(ranks.mean()),
                    nonfinite_count=float(h[:, 3].sum()),
                    acc_nonfinite=float(
                        (~torch.isfinite(work.sigma_acc)).sum()))
                # the reads above waited for the chunk's replays: the
                # stage times and GIG counts of each pattern's timed
                # replay among them
                for pattern in self._sampled:
                    self.stages.add(self._timed[pattern].clock)
                self._sampled.clear()
            if own:
                wait_readers(carry, self._stream)
                for dst, src in zip(carry_tensors(carry),
                                    carry_tensors(work), strict=True):
                    dst.copy_(src)
                carry.iteration = work.iteration
        return carry, stats, trace

    def _load(self, carry: ChainCarry) -> None:
        """Copy a chain's own carry into the static one (created on first
        use with the chain's shapes)."""
        if self.carry is None:
            self.carry = carry_like(carry, [torch.empty_like(t) for t in
                                            carry_tensors(carry)])
        for dst, src in zip(carry_tensors(self.carry), carry_tensors(carry),
                            strict=True):
            dst.copy_(src)
        self.carry.iteration = carry.iteration

    def _trip(self, chain: int, start: int, pattern: tuple,
              rows: Optional[torch.Tensor] = None) -> None:
        """One trip of the chain from ``start`` with save ``pattern``, its
        trace rows copied into ``rows`` where given.  While a profiler
        records each step is a range (profiling.py); the one flag check
        is made here, once a trip."""
        on = recording()
        n = len(pattern)
        if self._recipe is None:
            # the runner's first trip: live draws, the first sweep's calls
            # recorded as the recipe every later trip is drawn from
            with scope("api.chain.eager", on):
                self._write_its(start, n)
                recipe: list = []
                draws = [RecordingDraws(self.noise.sweep(chain, start),
                                        recipe)]
                draws += [self.noise.sweep(chain, start + j)
                          for j in range(1, n)]
                self._sweeps(draws, pattern)
                if rows is not None:
                    rows.copy_(self._trace[:n])
            self._recipe = recipe
            self._slots = [torch.empty((self.unroll, *c.shape),
                                       dtype=torch.float32,
                                       device=self.Y.device) for c in recipe]
            self._seen.add(pattern)
            self.eager_trips += 1
            return
        with scope("api.chain.draw", on):
            self._write_its(start, n)
            draws = self._predrawn(chain, start, n)
        if not self.use_graphs or pattern not in self._seen:
            with scope("api.chain.eager", on):
                self._sweeps(draws, pattern)
                if rows is not None:
                    rows.copy_(self._trace[:n])
            self._seen.add(pattern)
            self.eager_trips += 1
            return
        graph = self._graphs.get(pattern)
        if graph is None:
            with scope("api.chain.capture", on):
                graph = self._graphs[pattern] = self._capture(pattern)
        if on and pattern not in self._sampled:
            # the pattern's first trip of the chunk while a profiler
            # records: its twin, which times the stages
            graph = self._timed.get(pattern)
            if graph is None:
                with scope("api.chain.capture", on):
                    graph = self._timed[pattern] = self._capture(
                        pattern, timed=True)
            self._sampled.add(pattern)
        with scope(graph.span, on):
            graph.graph.replay()
            if rows is not None:
                rows.copy_(self._trace[:n])
        cuda_lib.add_launches(graph.tally)
        self.replays += 1

    def _write_its(self, start: int, length: int) -> None:
        if self._its is not None:
            # the trip's iterations, start + 1 .. start + length, by a
            # kernel on the runner's stream (no host-to-device copy)
            torch.arange(start + 1, start + 1 + length,
                         out=self._its[:length])

    def _predrawn(self, chain: int, start: int, length: int) -> list:
        """The draws of the ``length`` sweeps after ``start``: each
        sweep's recipe drawn into its slots (outside any graph), handed
        out by BufferedDraws."""
        draws = []
        for j in range(length):
            slots = [s[j] for s in self._slots]
            draw_into(self.noise.sweep(chain, start + j), self._recipe, slots)
            draws.append(BufferedDraws(self._recipe, slots))
        return draws

    def _capture(self, pattern: tuple, *, timed: bool = False) -> "_Graph":
        """Capture the trip whose variates the slots hold into a CUDA
        graph; ``timed`` stamps its stage boundaries
        (profiling.StageClock)."""
        draws = [BufferedDraws(self._recipe, [s[j] for s in self._slots])
                 for j in range(len(pattern))]
        graph = torch.cuda.CUDAGraph()
        clock = (StageClock(len(pattern), sum(pattern), device=self.Y.device)
                 if timed else None)
        t = time.perf_counter()
        # Python's cyclic collector may run at any allocation, and a dead
        # cycle can hold CUDA graphs, events or pinned buffers (an
        # exception's traceback holds a killed fit's runner): destroyed
        # inside a capture, they invalidate it.  So no automatic collection
        # while a trip is captured
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the checkpoint writer's and the stream drain's
            # threads wait on side-stream events while a trip is captured,
            # and under the default global mode such a wait in ANY thread
            # invalidates the capture; the capturing thread itself still
            # may not make an unsafe call
            with cuda_lib.capture_tally() as tally:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream,
                                      capture_error_mode="thread_local"):
                    if clock is None:
                        self._sweeps(draws, pattern)
                    else:
                        with clock.timing():
                            self._sweeps(draws, pattern)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing a trip of {len(pattern)} sweeps (saves "
                f"{pattern}) into a CUDA graph failed: {e}") from e
        finally:
            if collecting:
                gc.enable()
        self.capture_s += time.perf_counter() - t
        self.captured += 1
        return _Graph(graph, tally, "api.chain.replay.save" if any(pattern)
                      else "api.chain.replay.plain", clock)

    def _sweeps(self, draws: list, pattern: tuple) -> None:
        """The trip: one sweep per entry of ``draws``, the packed panels
        added on the saved ones, health and trace rows; the results are
        written into the carry's tensors and the trace buffer in place."""
        carry, cfg = self.carry, self.cfg
        sq_r, sq_1mr = math.sqrt(cfg.rho), math.sqrt(1.0 - cfg.rho)
        state, health = carry.state, carry.health
        for j, d in enumerate(draws):
            # the completed data: the incoming state's imputation of the
            # missing entries, read by every conditional of the sweep
            Yc = self.Y
            if self._mask is not None:
                with scope("impute_missing"):
                    Yc = impute_missing_y(d, self.Y, state, cfg.rho,
                                          self._mask)
            state, sse = gibbs_sweep(d, Yc, state, cfg, self.prior,
                                     reduce_fn=self._reduce)
            # the trace reads the sweep's own output; adaptation re-masks
            # the carried state after it (the JAX package's order)
            sweep_state = state
            if cfg.rank_adapt:
                with scope("adapt_rank"):
                    state = adapt_rank(d, state, self._its[j], self.burnin,
                                       cfg)
            if isinstance(d, BufferedDraws):
                d.finish()
            if pattern[j]:
                with scope("combine"):
                    eta = (sq_r * state.X[None] + sq_1mr * state.Z
                           if cfg.estimator == "scaled" else None)
                    # every shard's loadings, residual precisions and
                    # factors: all-gathered over the chain's ranks on the
                    # mesh (the rank's panels pair its shards with all)
                    every = state
                    if self._gather is not None:
                        every = dataclasses.replace(
                            state, Lambda=self._gather(state.Lambda),
                            ps=self._gather(state.ps))
                        eta = None if eta is None else self._gather(eta)
                    # the combine's cross-moments, formed once per saved
                    # draw for every chunk and kept for the ring too
                    H_grid = None if eta is None else cross_moments(eta)
                    add_panels(carry.sigma_acc, carry.sigma_sq_acc, every,
                               cfg.rho, self._rows, self._cols,
                               self._pair_chunks, eta=eta, H_grid=H_grid,
                               compute_dtype=self._c_dtype)
                    if carry.y_imp_acc is not None:
                        carry.y_imp_acc += Yc
                    if carry.draws is not None:
                        if H_grid is not None and self._gather is not None:
                            # the rank's rows of the grid
                            H_grid = H_grid[self._off:
                                            self._off + state.ps.shape[0]]
                        self._store(carry.draws, state, H_grid,
                                    self._its[j])
            with scope("health_trace"):
                health = _health_update(health,
                                        _health_now(state, self.prior))
                self._trace[j].copy_(_trace_now(
                    sweep_state, sse, cfg.rho, self._reduce, self._g_all))
        for dst, src in zip(state_leaves(carry.state), state_leaves(state),
                            strict=True):
            dst.copy_(src)
        carry.health.copy_(health)

    def _store(self, ring: DrawBuffers, state: SamplerState,
               H_grid: Optional[torch.Tensor], it: torch.Tensor) -> None:
        """Write a saved draw into ring slot (it - burnin) // thin - 1, on
        the device from the iteration tensor ``it`` and clamped to the ring
        as the JAX package's ``dynamic_update_slice`` clamps."""
        slot = (torch.div(it.long() - self.burnin, self.thin,
                          rounding_mode="floor") - 1).clamp_(
            0, self.num_stored_draws - 1).view(1)
        for buf, val in ((ring.Lambda, state.Lambda), (ring.ps, state.ps),
                         (ring.X, state.X), (ring.H, H_grid)):
            if buf is not None:
                buf.index_copy_(0, slot, val[None])


# -- trace-gate registration (analysis/tracecheck.py) ---------------------

def trace_trip(runner: ChainRunner, chain: int = 0):
    """Chain ``chain``'s second trip on ``runner``, made ready to run:
    the static carry at the chain's initial state, the first trip run (on
    live draws, recording the recipe), the second trip's iteration tensor
    written and its variates drawn into the slots.  Returns a zero-argument
    callable that runs the second trip's sweeps on BufferedDraws against
    the static carry - what a capture records - once."""
    carry = runner.init_chain(chain)
    n = runner.unroll
    runner._trip(chain, 0, save_pattern(0, n, runner.burnin, runner.thin))
    carry.iteration = n
    pattern = save_pattern(n, n, runner.burnin, runner.thin)
    runner._write_its(n, n)
    draws = runner._predrawn(chain, n, n)
    return lambda: runner._sweeps(draws, pattern)


def trace_runner(device: str, cfg: ModelConfig, G: int, *, mesh=None
                 ) -> ChainRunner:
    """The trace gate's runner: ``G`` shards of seeded (G, 8, 6) data,
    trips of 2 sweeps with burn-in 2 and thin 2 - the second trip's
    pattern (False, True), so a saved draw's combine runs in it."""
    from dcfm_tpu_torch.models.priors import make_prior

    Y = trace_data((G, 8, 6), device)
    return ChainRunner(TorchNoise(0, device), Y, cfg, make_prior(cfg),
                       burnin=2, thin=2, unroll=2, graphs=False, mesh=mesh)


@register_trace_entry("models.run_chunk", sweep_body=True)
def _trace_run_chunk(device: str) -> TraceSpec:
    cfg = ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8)
    runner = trace_runner(device, cfg, 2)
    return TraceSpec(fn=trace_trip(runner), device=device,
                     carry=lambda: carry_tensors(runner.carry),
                     static_key=(cfg, runner.unroll))
