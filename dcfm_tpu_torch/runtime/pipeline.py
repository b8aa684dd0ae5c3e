"""The chunk loop and the streamed accumulator fetch.

The port of ``dcfm_tpu/runtime/pipeline.py`` for one process:

* :func:`run_chain` - the host-side chunk loop moved out of ``api.fit``:
  the chains run chunk-major (every chain advances one chunk before any
  chain starts the next, so all of them sit at one global iteration at
  each boundary); resume (runtime/resume.py); write-behind checkpoints
  (utils/checkpoint.AsyncCheckpointWriter) at the cadence
  ``checkpoint_every_chunks`` sets, light saves with periodic full
  sidecars; the save-failure policy; the divergence sentinel
  (resilience/sentinel.py) with its rewind; the R-hat early stop
  (``RunConfig.early_stop="rhat"``, :func:`early_stop_metrics`: a host
  decision on the chunk's trace rows, after which the boundary is the
  last one); and a snapshot of the pooled accumulator for the stream
  below at every boundary.
* :class:`StreamingFetcher` - the double-buffered device->host stream of
  quant8 accumulator snapshots.  Each boundary after the first saved draw
  sums the chains' accumulators in chain order into a device buffer and
  runs ``fetch_prep`` and ``cast_for_link`` on it on a side stream (and,
  under posterior_sd, the same for the second-moment sums through
  ``fetch_sd_prep``), while the next chunk computes; a drain thread lands
  the int8 panels - into the serve artifact's memmaps under
  ``FitConfig.stream_artifact``.  At most
  ``max_inflight`` snapshots are in flight: a boundary that finds every
  slot busy is skipped, and the final boundary waits for one.  The final
  snapshot is the post-hoc quant8 fetch's computation on the same sums
  with the same divisor (runtime/fetch.accumulator_window), so the
  streamed panels and scales are bitwise the post-hoc ones: snapshots,
  never deltas (float32 sums of deltas do not reproduce the running sum).

The card's copies never race the chain: a snapshot or a stream sum reads a
chain's carry on a side stream after waiting for the runner's work, and
appends its end event to the carry's ``readers``; the runner waits for
those events before it writes the carry again.  No snapshot runs inside a
capture: they all run between chunks.

On the shard mesh (parallel/shard.RankMesh) every rank runs the loop on
its own chains and block, and every decision that changes what the ranks
do next is one for all of them: the resume's (each rank reads the same
file), the warm start's (runtime/resume), the sentinel's and the early
stop's (reduced statistics, gathered traces), the saves' and each streamed
boundary's (rank 0's, broadcast).  An elastic grow's new chains are drawn
by each rank on its own block once the adopted file is scattered.  A
pod's ranks (parallel/multihost.py) resume collectively
(runtime/resume.resume_state_multiproc: each rank its own block) and each
writes its own ``.procK-of-N`` file with its own write-behind writer
(utils/checkpoint.save_checkpoint_multiprocess); the sentinel aborts
there instead of rewinding, as in the JAX package (a collective rewind
has no unanimity protocol).

Flight recorder (obs/): the loop emits the JAX package's events at each
boundary - ``chunk`` (one per boundary for all the chains, its ``dur_s``
the boundary's existing host clock), ``early_stop``, ``sentinel_trip``,
``chain_diverged``, ``sentinel_rewind``, ``stream_snapshot`` /
``stream_skip`` / ``stream_refused`` - and the drain thread a
``stream_drain`` span per landed snapshot; it sets the fit gauges of the
process default registry and fsyncs the event log after the boundary's
save.  All of it is host-side file and dict work between chunks: nothing
records inside a trip or a capture, and nothing adds a sync.

Fault seams (resilience/faults.py, ``DCFM_FAULT_PLAN``), at the JAX
package's places: ``stream_submit`` / ``stream_submit_post`` around each
boundary's streamed dispatch; boundary kills ``pre_save`` before the
boundary's save and ``post_save`` after the write-behind writer made that
save durable (only on a boundary that saved); ``poison_state`` NaNs every
chain's Lambda after the boundary, so the next one trips the sentinel.
Without a plan each seam is one truthiness check.

While a ``torch.profiler`` records, the state init is the range
``api.init`` (timed into ``init_s`` by the same helper), the chunk loop
``api.chain``, and a boundary's streamed dispatch and save
``api.chain.stream`` and ``api.chain.checkpoint`` (profiling.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import queue
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from dcfm_tpu_torch.models.sampler import (
    ChainCarry, ChainStats, DrawBuffers, num_saved_draws)
from dcfm_tpu_torch.models.state import SamplerState
from dcfm_tpu_torch.obs import metrics as obs_metrics
from dcfm_tpu_torch.obs.recorder import active as obs_active, record
from dcfm_tpu_torch.profiling import Phase, StageTally, scope
from dcfm_tpu_torch.resilience.faults import fault_event, fault_plan
from dcfm_tpu_torch.resilience.sentinel import (
    ChainDivergedError, DivergenceSentinel)
from dcfm_tpu_torch.runtime.fetch import (
    _fetch_stream, fetch_prep, fetch_sd_prep, quant8_drain, quant8_start)
from dcfm_tpu_torch.runtime.resume import (
    ElasticResume, ResumeContext, graft_into, resume_state,
    resume_state_multiproc, rewind_source)
from dcfm_tpu_torch.utils.checkpoint import (
    DRAW_LEAVES, AsyncCheckpointWriter, Snapshot, save_checkpoint,
    save_checkpoint_multiprocess)
from dcfm_tpu_torch.utils.diagnostics import ess, split_rhat


# the fit's progress gauges in the process default metrics registry
# (obs/metrics.py), set at every chunk boundary - host-side dict writes,
# never device work - as the JAX package's are
_REG = obs_metrics.default_registry()
_G_ITER = _REG.gauge(
    "dcfm_fit_iteration",
    "global Gibbs iteration at the last completed chunk boundary")
_G_CHUNK_S = _REG.gauge(
    "dcfm_fit_chunk_seconds",
    "wall-clock seconds of the last completed chunk")
_G_STREAM_SKIPS = _REG.gauge(
    "dcfm_fit_stream_skips",
    "chunk boundaries skipped by the streamed fetch (both double-buffer "
    "slots busy)")
_G_REWINDS = _REG.gauge(
    "dcfm_fit_sentinel_rewinds",
    "divergence-sentinel rewinds performed by the current fit")
_G_CK_GEN = _REG.gauge(
    "dcfm_fit_checkpoint_generation",
    "checkpoint saves completed by the current fit (the write-behind "
    "generation counter)")
# The JAX package counts chunk boundaries whose carry came back with
# another placement than it went in (a relayout copy of the donated
# carry).  The port's carry is one static tensor set per rank that the
# runner writes in place, on the shard mesh too (parallel/shard.py: each
# rank's block never moves), so the gauge reads 0 on every boundary; the
# ``carry_relayout`` event marks the one boundary where a rank's carry
# tensors moved: a mesh resume, which scatters the file's global leaves
# into the ranks' blocks.
_G_RELAYOUTS = _REG.gauge(
    "dcfm_fit_carry_relayouts",
    "steady-state chunk boundaries where the carry came back with a "
    "different placement (sharding/layout) than it went in - each one "
    "is a per-chunk relayout copy of the biggest buffers on the device; "
    "MUST read 0 once the chunk program is warm")


def _flush_events() -> None:
    """The boundary's durability point of the flight recorder: the event
    log up to here survives a kill."""
    rec = obs_active()
    if rec is not None:
        rec.flush(fsync=True)


def chunk_schedule(num_iters: int, chunk: int) -> list:
    """Full chunks and one remainder chunk, exactly ``num_iters`` (every
    draw is keyed on the global iteration, so neither chunking nor a
    resume boundary changes the chain)."""
    out = [chunk] * (num_iters // chunk)
    if num_iters % chunk:
        out.append(num_iters % chunk)
    return out


def auto_cadence(last_save_seconds: float, chunk_secs: list) -> int:
    """``checkpoint_every_chunks="auto"``: the boundaries between saves
    such that one save (its copy and its write, ``last_save_seconds``)
    fits with 1.5x headroom in the chunks it overlaps; chunk 0 (first-use
    costs) is left out of the mean when there are others."""
    steady = chunk_secs[1:] if len(chunk_secs) > 1 else chunk_secs
    mean_chunk = sum(steady) / len(steady)
    return max(1, int(np.ceil(1.5 * last_save_seconds
                              / max(mean_chunk, 1e-9))))


def pool_stats(stats: list) -> ChainStats:
    """The chains' ChainStats reduced to one (max, min, max; min, max and
    mean of the ranks; sums)."""
    return ChainStats(
        tau_log_max=max(s.tau_log_max for s in stats),
        ps_min=min(s.ps_min for s in stats),
        ps_max=max(s.ps_max for s in stats),
        rank_min=min(s.rank_min for s in stats),
        rank_max=max(s.rank_max for s in stats),
        rank_mean=float(np.mean([s.rank_mean for s in stats])),
        nonfinite_count=sum(s.nonfinite_count for s in stats),
        acc_nonfinite=sum(s.acc_nonfinite for s in stats))


def early_stop_metrics(traces: list, trace0: int, burnin: int) -> tuple:
    """``(rhat_max, ess_min)`` over the post-burn-in slice of the chunks'
    trace rows - the convergence check of ``early_stop="rhat"`` at each
    boundary (the JAX package's, bit for bit).

    ``traces`` is run_chain's ``(start iteration, (C, ni, 4) host array)``
    list, covering global iterations ``trace0 + 1 ..``.  NaN while the
    post-burn-in window is shorter than 4 draws or holds one chain: NaN
    never stops a chain.  The worst summary decides: its R-hat must clear
    the threshold and its pooled ESS the target, and ``np.max`` /
    ``np.min`` let a NaN diagnostic keep the chain sampling."""
    arr = np.concatenate([t if t.ndim == 3 else t[None] for _, t in traces],
                         axis=1)
    post = arr[:, max(burnin - trace0, 0):, :]
    if post.shape[0] < 2 or post.shape[1] < 4:
        return float("nan"), float("nan")
    rhat_max = float(np.max([split_rhat(post[:, :, i])
                             for i in range(post.shape[2])]))
    ess_min = float(np.min([ess(post[:, :, i])
                            for i in range(post.shape[2])]))
    return rhat_max, ess_min


def carries_from_leaves(leaves: dict, num_chains: int, device,
                        acc_shape: tuple, *,
                        posterior_sd: bool = False,
                        y_imp_shape: Optional[tuple] = None) -> list:
    """The chains' carries on ``device`` from checkpoint leaves (a light
    file's accumulators restart at zero: the covariance sums of
    ``acc_shape``, the imputation sum of ``y_imp_shape`` when the fit
    imputes); the draw ring where the file holds one."""
    def get(name, c):
        a = leaves[name]
        return torch.as_tensor(np.array(a[c] if num_chains > 1 else a,
                                        copy=True), device=device)

    def acc(name, c, shape=acc_shape):
        return (get(name, c) if name in leaves
                else torch.zeros(shape, dtype=torch.float32, device=device))

    def ring(c):
        if "draws_Lambda" not in leaves:
            return None
        return DrawBuffers(*(get(k, c) if k in leaves else None
                             for k in DRAW_LEAVES))

    # every leaf that is not one of these is the prior's
    others = {"Lambda", "Z", "X", "ps", "active", "sigma_acc",
              "sigma_sq_acc", "iteration", "health", "y_imp_acc",
              *DRAW_LEAVES}
    out = []
    for c in range(num_chains):
        out.append(ChainCarry(
            state=SamplerState(
                *(get(k, c) for k in ("Lambda", "Z", "X", "ps")),
                prior={k: get(k, c) for k in sorted(leaves)
                       if k not in others},
                active=get("active", c) if "active" in leaves else None),
            sigma_acc=acc("sigma_acc", c),
            iteration=int(np.asarray(leaves["iteration"]).reshape(-1)[c]),
            health=get("health", c),
            sigma_sq_acc=acc("sigma_sq_acc", c) if posterior_sd else None,
            draws=ring(c),
            y_imp_acc=(None if y_imp_shape is None
                       else acc("y_imp_acc", c, y_imp_shape))))
    return out


@dataclasses.dataclass
class _StreamJob:
    started: tuple             # runtime.fetch.quant8_start's
    final: bool
    sources: list              # the summed accumulators, alive until drained
    sd_started: Optional[tuple] = None     # the SD panels' drain


class StreamingFetcher:
    """Double-buffered background drain of per-boundary quant8 snapshots
    of the chains' pooled accumulator (module docstring).

    ``inv_count`` and ``bessel`` are the final window's divisor and
    Bessel factor (the post-hoc fetch's, runtime/fetch.accumulator_window);
    a sentinel rewind that moves the window resets them
    (:meth:`reset_window`).  A carry with a second-moment accumulator
    (posterior_sd) streams its SD panels beside the mean's.  ``land_mean``
    / ``land_sd`` are landing buffers for the drained int8 panels (the
    serve artifact's writable memmaps, serve/artifact.
    begin_streamed_artifact); without them the drain's own host arrays
    are kept.

    On the shard mesh (``mesh``: parallel/shard.RankMesh) every rank
    keeps one: each boundary's decision is rank 0's, broadcast
    (:meth:`RankMesh.decide`: only rank 0 drains, so only its slots
    count); a snapshot sums the rank's chains into the streamer's own
    buffers, and :meth:`RankMesh.link_panels` pools them over the chain
    rows, quantizes each pair slice and gathers the int8 slices and
    scales to rank 0 in pair order - the post-hoc mesh fetch's
    computation on the same sums, so the panels are its bytes.  Those
    collectives are issued by the main thread at the boundary, on the
    chain's stream (NCCL orders a communicator's work, the sweep's
    captured collectives included, by its issue on each rank); the drain
    thread only copies rank 0's panels to the host and lands them, and
    the other ranks never queue a job.  A stream that fails on the mesh
    raises: the post-hoc fetch is collective, so no rank falls back to it
    alone."""

    def __init__(self, inv_count, num_chains: int, g: int, *,
                 bessel=None, land_mean: Optional[np.ndarray] = None,
                 land_sd: Optional[np.ndarray] = None,
                 max_inflight: int = 2, mesh=None):
        self._inv_count, self._bessel = inv_count, bessel
        self._C, self._g = num_chains, g
        self._mesh = mesh
        self._leader = mesh is None or mesh.rank == 0
        self._buf: Optional[torch.Tensor] = None
        self._buf_sq: Optional[torch.Tensor] = None
        self.land_mean, self.land_sd = land_mean, land_sd
        self.q8: Optional[np.ndarray] = None
        self.scales: Optional[np.ndarray] = None
        self.sd_q8: Optional[np.ndarray] = None
        self.sd_scales: Optional[np.ndarray] = None
        self.snapshots = self.skipped = 0
        self.chunk_fetch_s: list = []
        # seconds the final submit waited for a free slot: exposed fetch
        # time spent inside the chunk loop
        self.final_wait_s = 0.0
        self.final_landed = False
        self._slots = threading.Semaphore(max_inflight)
        self._queue: "queue.Queue" = queue.Queue()
        self._error: Optional[BaseException] = None
        self.failed = False          # the drain died: refusals from here on
        self._finished = False
        # non-daemon: finish()/abort() join it, and the interpreter joins
        # an abandoned one at exit
        self._worker = threading.Thread(target=self._drain_loop,
                                        name="dcfm-stream-drain")
        self._worker.start()

    def reset_window(self, inv_count, bessel=None) -> None:
        """A sentinel rewind moved the window: its new divisor (snapshots
        already queued are superseded by the final one)."""
        self._inv_count, self._bessel = inv_count, bessel

    def truncate(self, inv_count, bessel=None) -> None:
        """An early stop moved the window's END: the divisor of the
        truncated window, before the stop boundary's final submit
        quantizes with it (every landing queued before is superseded)."""
        self.reset_window(inv_count, bessel)

    @staticmethod
    def _sum(buf, accs):
        """The chain-order sum of ``accs`` into ``buf`` (created on first
        use)."""
        if buf is None:
            buf = torch.empty_like(accs[0])
        buf.copy_(accs[0])
        for a in accs[1:]:
            buf += a
        return buf

    def _take_slot(self, final: bool) -> bool:
        """A slot for this boundary's snapshot, or False (skipped).  A
        non-final boundary never blocks; the final one waits for a slot.
        On the mesh rank 0 takes the slot and its decision is every
        rank's."""
        if self._mesh is not None and self.failed:
            raise RuntimeError("the streamed fetch's drain failed on the "
                               "mesh") from self._error
        if self.failed:
            return False
        if final:
            if self._leader:
                t = time.perf_counter()
                self._slots.acquire()
                self.final_wait_s = time.perf_counter() - t
            return True
        got = self._leader and self._slots.acquire(blocking=False)
        if self._mesh is not None:
            (got,) = self._mesh.decide(got)
        if not got:
            self.skipped += 1
        return got

    def submit(self, carries: list, *, final: bool = False) -> bool:
        """Dispatch one boundary's snapshot: the chain-order sums, the
        quant8 preps and the start of their drains.  A non-final submit
        never blocks: with every slot busy the boundary is skipped (False).
        The final submit waits for a slot."""
        if not self._take_slot(final):
            return False
        try:
            accs = [c.sigma_acc for c in carries]
            sqs = [getattr(c, "sigma_sq_acc", None) for c in carries]
            sqs = None if sqs[0] is None else sqs
            dev = accs[0].device
            side = None
            if dev.type == "cuda" and self._mesh is None:
                side = _fetch_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
            with (torch.cuda.stream(side) if side is not None
                  else contextlib.nullcontext()):
                self._buf = self._sum(self._buf, accs)
                if sqs is not None:
                    self._buf_sq = self._sum(self._buf_sq, sqs)
                if side is not None:
                    read = torch.cuda.Event()
                    read.record(side)
                    for c in carries:
                        c.readers.append(read)
                started = sd_started = None
                if self._mesh is None:
                    q, scale = fetch_prep(self._buf, self._C, self._g,
                                          self._inv_count, "quant8")
                    started = quant8_start(q, scale)
                    if sqs is not None:
                        sd_started = quant8_start(*fetch_sd_prep(
                            self._buf_sq, self._buf[:q.shape[0]], self._C,
                            self._inv_count, self._bessel, "quant8"))
                else:
                    link = self._mesh.link_panels(
                        self._buf, self._buf_sq, self._inv_count,
                        self._bessel, "quant8")
                    if link is not None:            # rank 0
                        started = quant8_start(*link[0])
                        if link[1] is not None:
                            sd_started = quant8_start(*link[1])
        except BaseException:
            if self._leader:
                self._slots.release()   # a later final submit waits on it
            raise
        self.snapshots += 1
        if self._leader:
            self._queue.put(_StreamJob(started, final, accs, sd_started))
        return True

    def finish(self) -> dict:
        """Join the drain (the caller times the join: it is the exposed
        fetch) and return the landed panels and the telemetry; raises the
        drain's stored failure (the caller falls back to the post-hoc
        fetch: the carries are still alive)."""
        self._close()
        if self._error is not None:
            e, self._error = self._error, None
            raise e
        return {"q8": self.q8, "scales": self.scales,
                "sd_q8": self.sd_q8, "sd_scales": self.sd_scales,
                "final_landed": self.final_landed,
                "snapshots": self.snapshots, "skipped": self.skipped,
                "final_wait_s": self.final_wait_s,
                "chunk_fetch_s": list(self.chunk_fetch_s)}

    def abort(self) -> None:
        """Exception path: stop the drain without raising its errors."""
        self._close()
        self._error = None

    def _close(self) -> None:
        if not self._finished:
            self._finished = True
            self._queue.put(None)
            self._worker.join()
            self._buf = self._buf_sq = None

    @staticmethod
    def _land(q8: np.ndarray, land: Optional[np.ndarray]) -> np.ndarray:
        if land is None:
            return q8
        land[...] = q8
        return land

    def _drain_loop(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                if self._error is None:
                    t = time.perf_counter()
                    q8, self.scales = quant8_drain(job.started)
                    self.q8 = self._land(q8, self.land_mean)
                    if job.sd_started is not None:
                        q8, self.sd_scales = quant8_drain(job.sd_started)
                        self.sd_q8 = self._land(q8, self.land_sd)
                    if job.final:
                        self.final_landed = True
                    dur = time.perf_counter() - t
                    self.chunk_fetch_s.append(dur)
                    # the drain's span (obs/spans.py draws it beside the
                    # chunk slices it overlaps): a file write, no card call
                    record("stream_drain", final=bool(job.final), dur_s=dur,
                           with_sd=job.sd_started is not None)
            except BaseException as e:      # surfaced by finish()
                self._error = e
                self.failed = True
            finally:
                job.sources = None
                self._slots.release()


@dataclasses.dataclass
class ChainRunResult:
    """What the chunk loop hands back to ``api.fit``'s epilogue."""

    carries: list
    stats: Optional[ChainStats]    # None after a no-op resume
    executed: int
    traces: list                   # (C, iters, 4) host arrays per chunk
    chunk_seconds: list
    done: int                      # the iteration the run started at
    acc_start: int
    elastic: Optional[ElasticResume]   # ResumeContext.elastic
    checkpoint_error: Optional[str]
    rewinds: int
    trace0: int                    # global iteration the traces start at
    streamer: Optional[StreamingFetcher]
    graphs: dict                   # the runners' graph counts, summed,
                                   # their sampled stage times and
                                   # GIG counts (profiling.StageTally)
    # the R-hat early stop: the global iteration the run stopped at (None:
    # it ran its schedule), and the [iteration, rhat_max, ess_min] row of
    # every boundary it was evaluated at (None when early_stop is off)
    stopped_at_iter: Optional[int] = None
    rhat_trajectory: Optional[list] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)  # dcfm-torch: ignore[DCFM801] - the boundary's timing point (init_s, chunk_secs) and a rewind's retire, after the chunk's trace rows were read


def _poison(carries: list) -> None:
    """The fault plan's ``poison_state``: every chain's Lambda becomes NaN,
    simulating a divergence on the card, so the next chunk's health
    reduction trips the sentinel as a real blow-up would.  The tensor is
    rebound, never written in place: a snapshot of this boundary may still
    be reading the old one on its side stream, and the runner copies the
    chain's carry into the static carry its graphs read at the start of
    every chunk (``ChainRunner.run_chunk``), so the NaN reaches the graph."""
    for c in carries:
        c.state = dataclasses.replace(
            c.state, Lambda=c.state.Lambda * float("nan"))


_GRAPH_KEYS = ("captured", "capture_s", "replays", "eager_trips")


def run_chain(*, cfg, model, run, phase: dict, fingerprint, template: dict,
              make_runner: Callable, device: torch.device,
              window_fn: Optional[Callable] = None,
              make_streamer: Optional[Callable] = None,
              mesh=None) -> ChainRunResult:
    """The host-side chunk loop.  ``make_runner(model, lineage)`` builds a
    ``models/sampler.ChainRunner`` for ``model`` (the base ModelConfig, or
    the sentinel's jitter-escalated one after a rewind) on streams of the
    given lineage; ``window_fn(acc_start, elastic, total=None)`` is the
    fetch divisor and Bessel factor of the window ending at ``total``
    (default: the schedule's end; ``elastic``: ResumeContext.elastic),
    which only the stream reads; ``make_streamer(acc_start, elastic)``
    builds the :class:`StreamingFetcher`, once the resume point is known
    and only if a chunk will run.

    On the shard mesh (``mesh``: parallel/shard.RankMesh) every rank runs
    this loop over its own chains and block: a resume scatters the file's
    leaves (``RankMesh.local_leaves``), each boundary reduces the health
    statistics and gathers the trace rows over the ranks, so every rank
    takes the same early-stop and sentinel decisions, rank 0 decides the
    saves and writes each from every chain's carry gathered to it - on a
    pod every rank writes its own file instead.  The returned carries are
    the rank's own."""
    C = run.num_chains
    chains = list(range(C)) if mesh is None else list(mesh.layout.chains)
    leader = mesh is None or mesh.rank == 0
    pod = mesh is not None and mesh.pod
    chunk = run.chunk_size or run.total_iters
    graphs = dict.fromkeys(_GRAPH_KEYS, 0)
    stages = StageTally()

    def retire(r):
        for k in _GRAPH_KEYS:
            graphs[k] += getattr(r, k)
        stages.merge(r.stages)

    init = Phase("api.init", phase, "init_s").start()
    lineage: tuple = ()
    m_active = model
    runner = make_runner(m_active, lineage)

    # an elastic grow's new chains on the mesh: {global chain: lineage},
    # drawn by each rank on its own block once the file is scattered
    born: dict = {}

    def birth(c, elastic_lineage):
        # an elastic grow's new chain: its initial state on the bumped
        # lineage, as host leaves.  On the mesh a rank holds only its
        # block of a chain, so the adoption takes zeros of the global
        # shapes here, and every rank replaces its block of each birth
        # with its own runner.new_chain draw after the scatter (below):
        # noise.ShardSliceNoise makes that block the slice of the
        # one-device birth
        if mesh is None:
            return Snapshot([runner.new_chain(c, elastic_lineage)],
                            state_only=False).wait()
        born[c] = elastic_lineage
        return {k: np.zeros(shape[1:], dtype)
                for k, (shape, dtype) in template.items()}

    acc_shape = template["sigma_acc"][0][-3:]
    y_imp_shape = (template["y_imp_acc"][0][-3:] if "y_imp_acc" in template
                   else None)
    if mesh is not None:
        # the rank's packed panels and block of shards
        acc_shape = (mesh.layout.local_pairs,) + tuple(acc_shape[1:])
        if y_imp_shape is not None:
            y_imp_shape = (mesh.layout.local_shards,) + tuple(
                y_imp_shape[1:])

    def from_leaves(leaves):
        # a pod's resume reads the rank's own block already
        if mesh is not None and not pod:
            leaves = mesh.local_leaves(leaves)
            record("carry_relayout", iteration=int(np.asarray(
                leaves["iteration"]).reshape(-1)[0]), ranks=mesh.world)
        return carries_from_leaves(
            leaves, len(chains), device, acc_shape,
            posterior_sd=model.posterior_sd, y_imp_shape=y_imp_shape)

    fresh: list = []

    def new_chains():
        # the chains' initial carries, made once: a warm start grafts its
        # donor's state into these
        if not fresh:
            fresh.extend(runner.new_chain(c) for c in chains)
        return fresh

    rctx = ResumeContext(cfg=cfg, fingerprint=fingerprint, template=template,
                         birth=birth, fresh=new_chains, mesh=mesh)
    leaves, done, acc_start = (resume_state_multiproc if pod
                               else resume_state)(rctx)
    if leaves is None:
        carries = list(new_chains())
        if rctx.warm is not None:
            graft_into(carries, rctx.warm)
    else:
        carries = from_leaves(leaves)
        for i, c in enumerate(chains):
            if c in born:
                # the birth's initial carry with the adopted file's
                # iteration (its accumulators start at zero either way)
                carries[i] = dataclasses.replace(
                    runner.new_chain(c, born[c]), iteration=done)
    del leaves
    fresh.clear()       # a rewind must be able to free the first carries
    _sync(device)
    init.stop()
    executed = run.total_iters - done
    stats, traces, chunk_secs = None, [], []
    phase["checkpoint_s"] = 0.0
    saving = bool(cfg.checkpoint_path)
    # on the mesh rank 0 writes, every rank takes part in the gathers; on
    # a pod every rank writes its own file
    writer = AsyncCheckpointWriter() if saving and (leader or pod) else None
    save_fn = (functools.partial(save_checkpoint_multiprocess,
                                 layout=mesh.layout) if pod
               else save_checkpoint)
    light_mode = cfg.checkpoint_mode == "light"
    cadence = cfg.checkpoint_every_chunks
    auto = cadence == "auto"
    if auto:
        cadence = 1
    since_save, saves_done, ck_error = 0, 0, None

    def save_failure(e, last):
        """Before the last boundary a failed save re-raises (fail fast,
        lose one chunk); once the chain is complete it only warns and
        sets FitResult.checkpoint_error."""
        nonlocal ck_error
        if not last:
            raise e
        warnings.warn(f"checkpoint save failed: {e!r}; results are "
                      "returned but the run is NOT resumable from its end",
                      RuntimeWarning)
        ck_error = repr(e)

    # the fault plan (resilience/faults.py): None outside chaos runs, and
    # then every seam below is one truthiness check
    plan = fault_plan()
    s_mode = cfg.sentinel
    if s_mode == "auto":
        s_mode = "rewind" if cfg.checkpoint_path and not pod else "abort"
    elif s_mode == "rewind" and pod:
        warnings.warn(
            "sentinel='rewind' is not supported on multi-process runs (a "
            "collective rewind needs its own unanimity protocol); "
            "degrading to 'abort' - a divergence will raise "
            "ChainDivergedError instead of rewinding", RuntimeWarning)
        s_mode = "abort"
    sentinel = None
    if s_mode in ("abort", "rewind") and executed:
        baseline = sum(float(c.health[..., 3].sum()) for c in carries)
        if mesh is not None:
            baseline = mesh.total(baseline)
        sentinel = DivergenceSentinel(
            s_mode, max_rewinds=cfg.sentinel_max_rewinds,
            baseline_nonfinite=baseline, base_jitter=model.ridge_jitter)
    trace0 = it_now = done
    streamer = (make_streamer(acc_start, rctx.elastic)
                if make_streamer is not None and executed else None)
    queue_ = chunk_schedule(executed, chunk)
    qi = 0
    # the R-hat early stop: a host decision on the trace rows each chunk
    # fetches anyway, at boundaries only (the chain's work never changes)
    es_on = run.early_stop == "rhat"
    stopped_at = None
    rhat_traj = [] if es_on else None
    loop = Phase("api.chain").start()
    try:
        while qi < len(queue_):
            ni = queue_[qi]
            qi += 1
            t = time.perf_counter()
            chain_stats, chain_traces = [], []
            for i, c in enumerate(chains):
                # (the returned carry is not kept: a rewind must be able
                # to free every chain's old carry)
                st, tr = runner.run_chunk(c, carries[i], ni)[1:]
                chain_stats.append(st)
                chain_traces.append(tr.cpu().numpy())  # dcfm-torch: ignore[DCFM801] - per-chunk trace rows are KBs; an async drain would buy nothing
            chain_traces = np.stack(chain_traces)
            stats = pool_stats(chain_stats)
            if mesh is not None:
                chain_traces = mesh.gather_traces(chain_traces)
                stats = mesh.reduce_stats(stats)
            _sync(device)
            chunk_secs.append(time.perf_counter() - t)
            it_now += ni
            traces.append((it_now - ni, chain_traces))
            if es_on:
                rhat_max, ess_min = early_stop_metrics(traces, trace0,
                                                       run.burnin)
                rhat_traj.append([it_now, rhat_max, ess_min])
                if (qi < len(queue_)
                        and np.isfinite(rhat_max) and np.isfinite(ess_min)
                        and rhat_max < run.rhat_threshold
                        and ess_min >= run.ess_target):
                    # converged: this boundary becomes the last one, so
                    # the final stream submit, the final save and the
                    # divisor all take the truncated window
                    queue_ = queue_[:qi]
                    stopped_at = it_now
                    if streamer is not None:
                        streamer.truncate(*window_fn(acc_start, rctx.elastic,
                                                     it_now))
                    record("early_stop", iteration=it_now,
                           rhat=round(rhat_max, 5), ess=round(ess_min, 2),
                           rhat_threshold=run.rhat_threshold,
                           ess_target=run.ess_target,
                           total_iters=run.total_iters)
            last = qi == len(queue_)
            record("chunk", start=it_now - ni, end=it_now, iters=ni,
                   dur_s=chunk_secs[-1], final=last)
            _G_ITER.set(it_now)
            _G_CHUNK_S.set(chunk_secs[-1])
            _G_RELAYOUTS.set(0)
            if streamer is not None:
                _G_STREAM_SKIPS.set(streamer.skipped)
            if sentinel is not None:
                _G_REWINDS.set(sentinel.rewinds)
            if sentinel is not None and sentinel.tripped(stats):
                record("sentinel_trip", iteration=it_now, mode=sentinel.mode)
                reloaded = None
                if sentinel.mode == "rewind":
                    if writer is not None:
                        try:
                            writer.wait()    # no racing an in-flight save
                        except Exception:  # dcfm: ignore[DCFM601] - a failed save of a diverged carry is moot mid-rewind
                            pass
                    if mesh is not None:
                        mesh.total(0.0)      # rank 0's save has landed
                    reloaded = rewind_source(rctx)
                if reloaded is None:
                    record("chain_diverged", iteration=it_now,
                           mode=sentinel.mode, rewinds=sentinel.rewinds)
                    raise ChainDivergedError(
                        "chain produced non-finite values in the chunk "
                        f"ending at iteration {it_now}"
                        + (" and no usable checkpoint exists to rewind to"
                           if sentinel.mode == "rewind"
                           else " (sentinel mode 'abort')"),
                        iteration=it_now, rewinds=sentinel.rewinds)
                try:
                    sentinel.record_rewind(it_now)  # raises past the budget
                except ChainDivergedError:
                    record("chain_diverged", iteration=it_now,
                           mode=sentinel.mode, rewinds=sentinel.rewinds)
                    raise
                it_tripped = it_now
                leaves, it_now, acc_start = reloaded
                record("sentinel_rewind", iteration=it_tripped,
                       to_iteration=it_now, acc_start=acc_start,
                       rewinds=sentinel.rewinds)
                # the rewound chains restart from the file on fresh
                # streams (the rewind count folded into their lineage) and
                # a 10x ridge jitter, which every captured graph has baked
                # in: the runner and its graphs are replaced
                _sync(device)
                retire(runner)
                del runner, carries
                carries = from_leaves(leaves)
                del leaves
                lineage = lineage + (sentinel.rewinds,)
                m_active = dataclasses.replace(
                    m_active, ridge_jitter=sentinel.escalated_jitter())
                runner = make_runner(m_active, lineage)
                trace0 = min(trace0, it_now)
                traces = [(s, tr) for s, tr in traces if s < it_now]
                if es_on:
                    # a rewind voids a stop decided on the dropped chunks,
                    # and the trajectory keeps the boundaries before it
                    stopped_at = None
                    rhat_traj = [r for r in rhat_traj if r[0] <= it_now]
                if streamer is not None:
                    # the rewound file carries its own elastic record
                    streamer.reset_window(*window_fn(acc_start,
                                                     rctx.elastic))
                queue_ = chunk_schedule(run.total_iters - it_now, chunk)
                qi = 0
                since_save = 0
                continue
            if streamer is not None:
                # before the checkpoint's snapshot, so the panels are
                # first on the link; burn-in boundaries (no saved draw
                # yet) skip
                draws = (num_saved_draws(it_now, run.burnin, run.thin)
                         - num_saved_draws(acc_start, run.burnin, run.thin))
                if rctx.elastic is not None:
                    # draws folded in from dropped chains are in the
                    # accumulator before this run saves any
                    draws += rctx.elastic.fold_draws
                if last or draws > 0:
                    fault_event("stream_submit")
                    with scope("api.chain.stream"):
                        try:
                            if streamer.submit(carries, final=last):
                                record("stream_snapshot", iteration=it_now,
                                       final=last)
                            elif streamer.failed:
                                # the drain died: "stream dead since k",
                                # never "double buffer saturated"
                                record("stream_refused", iteration=it_now)
                            else:
                                record("stream_skip", iteration=it_now)
                        except Exception as e:  # the stream is an optimization: the post-hoc fetch serves
                            if mesh is not None:
                                raise   # collective: no rank falls back alone
                            warnings.warn(
                                f"streamed fetch dispatch failed ({e!r}); "
                                "disabling streaming for this run - the "
                                "post-hoc fetch will serve the result",
                                RuntimeWarning)
                            streamer.abort()
                            streamer = None
                    fault_event("stream_submit_post")
            if not saving:
                _flush_events()
                if plan is not None:
                    plan.maybe_kill(it_now, done, "pre_save")
                    plan.maybe_kill(it_now, done, "post_save")
                    if plan.poison_due(it_now, done):
                        _poison(carries)
                continue
            due = full_due = False
            if writer is not None:
                if writer.poll_error() is not None and not last:
                    writer.wait()       # re-raises the stored failure
                if auto and writer.last_save_seconds is not None:
                    cadence = auto_cadence(writer.last_save_seconds,
                                           chunk_secs)
                since_save += 1
                if plan is not None:
                    # a pre-save kill lands before this boundary's save, so
                    # the checkpoint never passes the trigger: the poison
                    # drill
                    plan.maybe_kill(it_now, done, "pre_save")
                # the last boundary always saves; a still-running save
                # defers a non-final due save to the next boundary
                due = (since_save >= cadence and not writer.busy()) or last
                full_due = due and (light_mode
                                    and cfg.checkpoint_full_every > 0
                                    and (saves_done + 1)
                                    % cfg.checkpoint_full_every == 0)
            if mesh is not None:
                due, full_due = mesh.decide(due, full_due)
            saved_this_boundary = False
            if due:
                # light mode's full saves go to the sidecar (the next light
                # save replaces checkpoint_path), except the last one
                target = (cfg.checkpoint_path + ".full"
                          if full_due and not last else cfg.checkpoint_path)
                state_only = light_mode and not full_due
                # the birth lineage rides every save (a light resume
                # must not rewind it), the window bookkeeping every save
                # that keeps the accumulators
                kw = {}
                if rctx.elastic is not None:
                    kw["elastic_lineage"] = rctx.elastic.elastic_lineage
                    if not state_only:
                        kw.update(chain_acc_starts=list(
                            rctx.elastic.chain_acc_starts),
                            fold_draws=rctx.elastic.fold_draws)
                if rctx.pod is not None:
                    # the host-adoption count rides every save, as the
                    # lineage does
                    kw["pod_adoptions"] = rctx.pod["pod_adoptions"]
                with Phase("api.chain.checkpoint", phase, "checkpoint_s"):
                    to_save = carries
                    if mesh is not None and not pod:
                        # every chain's global carry, on rank 0: the one
                        # file a one-device fit writes
                        kw["num_devices"] = mesh.world
                        to_save = mesh.gather_carries(carries)
                    if writer is not None:
                        try:
                            writer.submit(save_fn, target, to_save, cfg,
                                          fingerprint=fingerprint,
                                          state_only=state_only,
                                          acc_start=acc_start,
                                          keep_last=cfg.checkpoint_keep_last,
                                          **kw)
                            saved_this_boundary = True
                        except Exception as e:  # the save-failure policy
                            save_failure(e, last)
                    del to_save
                since_save = 0
                saves_done += 1
                _G_CK_GEN.set(saves_done)
            _flush_events()
            if plan is not None:
                # a post-save kill must see a durable save: it arms only on
                # a boundary that saved (with a cadence above 1 it lands on
                # the next one that does), after the write-behind writer has
                # finished it - a failed write surfaces here as it would at
                # poll_error, downgraded on the last boundary only
                if saved_this_boundary:
                    try:
                        writer.wait()
                    except Exception as e:  # the save-failure policy
                        save_failure(e, last)
                    plan.maybe_kill(it_now, done, "post_save")
                if plan.poison_due(it_now, done):
                    _poison(carries)
        if writer is not None:
            # the last save must be durable before fit returns
            with Phase("api.chain.checkpoint", phase, "checkpoint_s"):
                try:
                    writer.wait()
                except Exception as e:  # the chain is complete: downgrade
                    save_failure(e, True)
    except BaseException:
        if streamer is not None:
            streamer.abort()
        raise
    finally:
        loop.stop()
    retire(runner)
    graphs.update(stage_ms=stages.means(), stage_samples=stages.samples)
    if stages.gig:
        graphs["gig"] = stages.gig
    if stopped_at is not None:
        # the truncated count: the divisor's window end, iters_per_sec
        executed = it_now - done
    return ChainRunResult(
        carries=carries, stats=stats, executed=executed,
        traces=[tr for _, tr in traces], chunk_seconds=chunk_secs,
        done=done, acc_start=acc_start, elastic=rctx.elastic,
        checkpoint_error=ck_error,
        rewinds=sentinel.rewinds if sentinel is not None else 0,
        trace0=trace0, streamer=streamer, graphs=graphs,
        stopped_at_iter=stopped_at, rhat_trajectory=rhat_traj)
