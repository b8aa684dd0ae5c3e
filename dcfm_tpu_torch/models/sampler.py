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
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import NamedTuple, Optional

import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.models.conditionals import covariance_panels, gibbs_sweep
from dcfm_tpu_torch.models.state import (
    SamplerState, init_state, num_padded_pairs, packed_pair_indices)
from dcfm_tpu_torch.noise import BufferedDraws, RecordingDraws, draw_into
from dcfm_tpu_torch.ops import cuda_lib

# per-iteration chain summaries, in the JAX package's order: mean signal
# variance, mean residual variance, their sum, average log-likelihood
TRACE_SUMMARIES = ("signal_var_mean", "resid_var_mean", "sigma_diag_mean",
                   "avg_loglik")


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
    # CUDA events of copies that still read these tensors on a side
    # stream (a checkpoint snapshot, a streamed-fetch sum): whatever writes
    # the carry next waits for them first (wait_readers)
    readers: list = dataclasses.field(default_factory=list)


def carry_tensors(carry: ChainCarry) -> list:
    """The carry's tensors in a fixed order: the state's leaves, the
    accumulator, health and, under posterior_sd, the second moment."""
    sq = [] if carry.sigma_sq_acc is None else [carry.sigma_sq_acc]
    return [*state_leaves(carry.state), carry.sigma_acc, carry.health, *sq]


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


def _trace_now(state: SamplerState, sse: torch.Tensor,
               rho: float) -> torch.Tensor:
    """(4,) summaries of one sweep's output, from the (G, P) SSE the psi
    stage already formed (no data-sized contraction)."""
    G, P = state.ps.shape
    n = state.X.shape[0]
    p_total = G * P
    eta = math.sqrt(rho) * state.X[None] + math.sqrt(1.0 - rho) * state.Z
    E = torch.einsum("gnk,gnj->gkj", eta, eta) / n
    M = torch.einsum("gpk,gkj->gpj", state.Lambda, E)
    sig_j = torch.sum(M * state.Lambda, dim=-1)                 # (G, P)
    loglik = 0.5 * torch.sum(
        n * (torch.log(state.ps) - math.log(2.0 * math.pi))
        - state.ps * sse, dim=-1)                               # (G,)
    signal, rvar, ll = torch.sum(torch.stack(
        [torch.sum(sig_j, dim=-1), torch.sum(1.0 / state.ps, dim=1),
         loglik], dim=-1), dim=0)
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


def init_chain(draws, Y: torch.Tensor, cfg: ModelConfig, prior) -> ChainCarry:
    """Initial state, zero packed accumulators and a fresh health panel."""
    G, n, P = Y.shape
    state = init_state(draws, prior, G=G, n=n, P=P,
                       K=cfg.factors_per_shard, as_=cfg.as_, bs=cfg.bs,
                       device=Y.device)
    acc = torch.zeros((num_padded_pairs(G), P, P), dtype=torch.float32,
                      device=Y.device)
    return ChainCarry(state=state, sigma_acc=acc, iteration=0,
                      health=_health_init(G, Y.device),
                      sigma_sq_acc=(torch.zeros_like(acc)
                                    if cfg.posterior_sd else None))


def state_leaves(state: SamplerState) -> list:
    """The state's tensors in a fixed order (the prior's by name)."""
    return [state.Lambda, state.Z, state.X, state.ps,
            *(state.prior[k] for k in sorted(state.prior))]


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


class ChainRunner:
    """Runs the chains of one fit on ``Y`` in trips of ``unroll`` sweeps.

    ``graphs`` (default: whether Y is on the card) makes each trip a CUDA
    graph: a (length, save pattern) is run eagerly the first time it is
    met, on the real chain (the warm-up), captured the second time and
    replayed from then on.  A capture advances nothing and counts no
    launch; each replay adds the launches its capture counted
    (cuda_lib.capture_tally).  All graphs share one memory pool and replay
    serially on the runner's stream, which also runs the eager trips and
    the draws.  ``graphs=False`` on the card is the eager chain the card
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
    """

    def __init__(self, noise, Y: torch.Tensor, cfg: ModelConfig, prior, *,
                 burnin: int, thin: int, unroll: int = 1, graphs=None):
        if unroll < 1:
            raise ValueError(f"unroll must be >= 1, got {unroll}")
        cuda = Y.device.type == "cuda"
        self.use_graphs = cuda if graphs is None else bool(graphs)
        if self.use_graphs and not cuda:
            raise ValueError("CUDA graphs need Y on a CUDA device")
        self.noise, self.Y, self.cfg, self.prior = noise, Y, cfg, prior
        self.burnin, self.thin, self.unroll = burnin, thin, unroll
        rows, cols = packed_pair_indices(Y.shape[0])
        self._rows = torch.as_tensor(rows, dtype=torch.long, device=Y.device)
        self._cols = torch.as_tensor(cols, dtype=torch.long, device=Y.device)
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
        self.carry = None
        self._recipe = None        # the sweep's draw calls, recorded once
        self._slots = None         # per call: (unroll, *shape) variates
        self._seen: set = set()    # save patterns run at least once
        self._graphs: dict = {}    # save pattern -> (graph, launch tally)
        self.captured, self.capture_s = 0, 0.0
        self.replays = self.eager_trips = 0

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
            self.carry = init_chain(self.noise.init(chain), self.Y,
                                    self.cfg, self.prior)
            return self.carry
        G, n, P = self.Y.shape
        state = init_state(self.noise.init(chain), self.prior, G=G, n=n,
                           P=P, K=self.cfg.factors_per_shard,
                           as_=self.cfg.as_, bs=self.cfg.bs,
                           device=self.Y.device)
        for dst, src in zip(state_leaves(self.carry.state),
                            state_leaves(state), strict=True):
            dst.copy_(src)
        self.carry.sigma_acc.zero_()
        if self.carry.sigma_sq_acc is not None:
            self.carry.sigma_sq_acc.zero_()
        self.carry.health.copy_(_health_init(G, self.Y.device))
        self.carry.iteration = 0
        return self.carry

    def new_chain(self, chain: int, lineage: int = 0) -> ChainCarry:
        """Chain ``chain``'s initial carry in tensors of its own (the
        static carry's values after ``init_chain(chain)``); ``lineage`` > 0
        draws it on a fresh lineage (an elastic birth)."""
        draws = (self.noise.init(chain, lineage) if lineage
                 else self.noise.init(chain))
        return init_chain(draws, self.Y, self.cfg, self.prior)

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
                    work.iteration, length, self.burnin, self.thin))
                trace[pos:pos + length].copy_(self._trace[:length])
                work.iteration += length
                pos += length
            h = work.health.cpu()
            stats = ChainStats(
                tau_log_max=float(h[:, 0].max()), ps_min=float(h[:, 1].min()),
                ps_max=float(h[:, 2].max()),
                nonfinite_count=float(h[:, 3].sum()),
                acc_nonfinite=float((~torch.isfinite(work.sigma_acc)).sum()))
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
            self.carry = ChainCarry(
                state=SamplerState(
                    *(torch.empty_like(getattr(carry.state, f))
                      for f in ("Lambda", "Z", "X", "ps")),
                    prior={k: torch.empty_like(v)
                           for k, v in carry.state.prior.items()}),
                sigma_acc=torch.empty_like(carry.sigma_acc), iteration=0,
                health=torch.empty_like(carry.health),
                sigma_sq_acc=(None if carry.sigma_sq_acc is None
                              else torch.empty_like(carry.sigma_sq_acc)))
        for dst, src in zip(carry_tensors(self.carry), carry_tensors(carry),
                            strict=True):
            dst.copy_(src)
        self.carry.iteration = carry.iteration

    def _trip(self, chain: int, start: int, pattern: tuple) -> None:
        if self._recipe is None:
            # the runner's first trip: live draws, the first sweep's calls
            # recorded as the recipe every later trip is drawn from
            recipe: list = []
            draws = [RecordingDraws(self.noise.sweep(chain, start), recipe)]
            draws += [self.noise.sweep(chain, start + j)
                      for j in range(1, len(pattern))]
            self._sweeps(draws, pattern)
            self._recipe = recipe
            self._slots = [torch.empty((self.unroll, *c.shape),
                                       dtype=torch.float32,
                                       device=self.Y.device) for c in recipe]
            self._seen.add(pattern)
            self.eager_trips += 1
            return
        draws = []
        for j in range(len(pattern)):
            slots = [s[j] for s in self._slots]
            draw_into(self.noise.sweep(chain, start + j), self._recipe, slots)
            draws.append(BufferedDraws(self._recipe, slots))
        if not self.use_graphs or pattern not in self._seen:
            self._sweeps(draws, pattern)
            self._seen.add(pattern)
            self.eager_trips += 1
            return
        graph = self._graphs.get(pattern) or self._capture(draws, pattern)
        graph[0].replay()
        cuda_lib.add_launches(graph[1])
        self.replays += 1

    def _capture(self, draws: list, pattern: tuple) -> tuple:
        graph = torch.cuda.CUDAGraph()
        t = time.perf_counter()
        try:
            with cuda_lib.capture_tally() as tally:
                with torch.cuda.graph(graph, pool=self._pool,
                                      stream=self._stream):
                    self._sweeps(draws, pattern)
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing a trip of {len(pattern)} sweeps (saves "
                f"{pattern}) into a CUDA graph failed: {e}") from e
        self.capture_s += time.perf_counter() - t
        self.captured += 1
        self._graphs[pattern] = (graph, tally)
        return graph, tally

    def _sweeps(self, draws: list, pattern: tuple) -> None:
        """The trip: one sweep per entry of ``draws``, the packed panels
        added on the saved ones, health and trace rows; the results are
        written into the carry's tensors and the trace buffer in place."""
        carry, cfg = self.carry, self.cfg
        sq_r, sq_1mr = math.sqrt(cfg.rho), math.sqrt(1.0 - cfg.rho)
        state, health = carry.state, carry.health
        for j, d in enumerate(draws):
            state, sse = gibbs_sweep(d, self.Y, state, cfg, self.prior)
            if isinstance(d, BufferedDraws):
                d.finish()
            if pattern[j]:
                eta = (sq_r * state.X[None] + sq_1mr * state.Z
                       if cfg.estimator == "scaled" else None)
                blocks = covariance_panels(
                    state.Lambda, state.ps, cfg.rho, self._rows, self._cols,
                    eta_all=eta, compute_dtype=self._c_dtype)
                carry.sigma_acc += blocks
                if carry.sigma_sq_acc is not None:
                    # the JAX package's acc_sq + blocks * blocks: the
                    # square rounded on its own (an in-place multiply, no
                    # second temporary), then the add - two kernels, so
                    # no compiler can contract them into an FMA
                    carry.sigma_sq_acc += blocks.mul_(blocks)
            health = _health_update(health, _health_now(state, self.prior))
            self._trace[j].copy_(_trace_now(state, sse, cfg.rho))
        for dst, src in zip(state_leaves(carry.state), state_leaves(state),
                            strict=True):
            dst.copy_(src)
        carry.health.copy_(health)
