"""The shard mesh: one fit over N rank processes of ``torch.distributed``.

The port of ``dcfm_tpu/parallel/shard.py``.  ``fit`` with
``BackendConfig.mesh_devices = N > 1`` runs the chain as N ranks - the
caller's process is rank 0 and starts ranks 1 .. N-1 (:func:`start_mesh`)
- over ``"nccl"`` on cards ``cuda:0 .. cuda:N-1``, or ``"gloo"`` on the
CPU.  Each rank holds its block of shards (parallel/mesh.RankLayout) and
runs the one-device chain program on it (models/sampler.ChainRunner with a
:class:`RankMesh`), with the JAX package's collective seam:

* the sweep's one cross-shard reduction (the X update's two sums over
  shards) and the chain trace's sums are the local sum then an all-reduce
  over the chain's ranks (:meth:`RankMesh.reduce_fn`);
* a saved draw's combine reads every shard's loadings, residual
  precisions and factors through an all-gather (:meth:`RankMesh.
  gather_fn`) and adds only the rank's packed panels;

and, at chunk boundaries, over all ranks: the chunk's health statistics
(max / min / sums, the rank mean a mean of equal-sized means), the chains'
trace rows, rank 0's checkpoint and stream decisions, a streamed quant8
snapshot (runtime/pipeline.StreamingFetcher: each rank's pair slice pooled
over the chain rows, quantized and gathered to rank 0,
:meth:`RankMesh.link_panels`), and the gather of every chain's carry to
rank 0 (:meth:`RankMesh.gather_carries`) for a save and for the result;
at the end, unless the fetch streamed, the post-hoc fetch on each rank's
pair slice, its link panels gathered to rank 0 (:meth:`RankMesh.fetch`).
A resume scatters the one file's global leaves into each rank's block
(:meth:`RankMesh.local_leaves`); a warm start grafts the donor's global
leaves into it (:func:`leaf_block`).  On the card the sweep's collectives
are issued inside the CUDA graphs of the trips (NCCL ops are capturable;
the trips' first meeting is eager, which creates the communicators) and
each is counted into ``ops/cuda_lib.COLLECTIVES`` as a kernel launch is.

A pod's rank (parallel/multihost.py: N processes started from outside,
``pod=True``) runs the same program with three differences: each rank
saves its own ``.procK-of-N`` file (utils/checkpoint.
save_checkpoint_multiprocess, its block at :func:`block_slices`), with no
gather of the carries for a save; its resume reads its own file
(runtime/resume.resume_state_multiproc); and the result is replicated -
what rank 0 gathered is shared with every rank (:meth:`RankMesh.share`),
so every process returns the same FitResult.  It starts and reaps no
rank, and its process group outlives the fit.

Process hygiene: every rank dies with its parent (``PR_SET_PDEATHSIG``),
runs one thread of intra-op parallelism (the CPU mesh shares its cores),
meets the others through a ``FileStore`` in a fresh temporary directory
(no fixed ports) and fails a collective that waits past :data:`TIMEOUT_S`
seconds.  A rank that dies breaks its peers' connections at once; the
caller then raises :class:`MeshRankError` naming the rank and its exit
code, and never returns before every rank it started has exited.
"""

from __future__ import annotations

import ctypes
import dataclasses
import datetime
import os
import shutil
import pickle
import signal
import subprocess
import sys
import tempfile
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from dcfm_tpu_torch.analysis.registry import TraceSpec, register_trace_entry
from dcfm_tpu_torch.models.sampler import (
    ChainCarry, ChainStats, carry_like, carry_shard_axes, carry_tensors)
from dcfm_tpu_torch.models.state import num_padded_pairs, num_upper_pairs
from dcfm_tpu_torch.ops import cuda_lib
from dcfm_tpu_torch.parallel.mesh import RankLayout, make_layout, pair_slice
from dcfm_tpu_torch.runtime.fetch import fetch_prep, fetch_sd_prep

# every collective's bound (gloo's own default is 30 minutes)
TIMEOUT_S = 300.0
# the checkpoint leaves kept whole on every rank, and those split along
# the packed-pair axis or along axis 1 (the draw ring's shard axis)
_REPLICATED = ("X", "draws_X", "iteration")
_PAIR_LEAVES = ("sigma_acc", "sigma_sq_acc")
_RING_LEAVES = ("draws_Lambda", "draws_ps", "draws_H")


class MeshRankError(RuntimeError):
    """A rank of a mesh fit died, raised, or missed a collective's
    timeout: the fit fails with it, in the caller."""


def _first_card(device: torch.device) -> int:
    return (device.index if device.index is not None
            else torch.cuda.current_device())


def check_mesh_devices(num_devices: int, device: torch.device) -> None:
    """The JAX package's refusal of a mesh wider than the devices it may
    span: the cards from ``device``'s on (:func:`rank_device`), or the CPU
    cores this process may run on (one gloo rank each)."""
    if device.type == "cuda":
        first = _first_card(device)
        have = max(torch.cuda.device_count() - first, 0)
        where = f" from cuda:{first}" if first else ""
    else:
        have, where = len(os.sched_getaffinity(0)), ""
    if num_devices > have:
        raise ValueError(
            f"mesh_devices={num_devices} but only {have} devices visible"
            f"{where} (no silent fallback; set mesh_devices=0 for "
            "single-device vmap)")


class RankMesh:
    """This process's place in the mesh and its collectives; the process
    group is initialized (:func:`start_mesh`, :func:`rank_main`, or a
    pod's parallel/multihost.initialize: ``pod=True``)."""

    def __init__(self, layout: RankLayout, device: torch.device, *,
                 pod: bool = False):
        self.layout, self.device, self.pod = layout, device, pod
        self.rank, self.world = layout.rank, layout.world
        self.num_shards = layout.num_shards
        self.shard_offset = layout.shard_offset
        self.pair_rows, self.pair_cols = pair_slice(layout)
        # every rank creates every row's group, then every column's (a
        # shard block's ranks across the chain rows), in the same order
        self._row = self._col = None
        if layout.rows > 1:
            for r in range(layout.rows):
                grp = dist.new_group(layout.row_ranks(r))
                if r == layout.row:
                    self._row = grp
            for c in range(layout.cols):
                grp = dist.new_group(list(range(c, layout.world,
                                                layout.cols)))
                if c == layout.col:
                    self._col = grp
        self.procs: list = []          # rank 0: the ranks it started
        self.tmpdir: Optional[str] = None

    # ---- the sweep's collectives (inside the trips and their graphs) ----

    def reduce_fn(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of a (Gl, ...) tensor over every shard of the chain."""
        s = torch.sum(x, dim=0)
        cuda_lib.count_collective("all_reduce")
        dist.all_reduce(s, group=self._row)
        return s

    def gather_fn(self, x: torch.Tensor) -> torch.Tensor:
        """(Gl, ...) -> (G, ...): every shard of the chain, in shard
        order."""
        x = x.contiguous()
        out = torch.empty((self.layout.cols * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        cuda_lib.count_collective("all_gather")
        dist.all_gather_into_tensor(out, x, group=self._row)
        return out

    # ---- chunk boundaries (all ranks, outside any graph) ----------------

    def _every(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (over the whole mesh): (world, *t.shape)."""
        t = t.contiguous()
        out = torch.empty((self.world * t.shape[0], *t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t)
        return out.view(self.world, *t.shape)

    def _vec(self, values) -> torch.Tensor:
        return torch.tensor([float(v) for v in values], dtype=torch.float64,  # dcfm-torch: ignore[DCFM301] - rank statistics crossing ranks at a chunk boundary: double keeps the summed counts exact; never enters the chain
                            device=self.device)

    def reduce_stats(self, s: ChainStats) -> ChainStats:
        """This rank's chains' statistics reduced over every rank, as the
        JAX package's pmax / pmin / pmean / psum."""
        hi = self._vec([s.tau_log_max, -s.ps_min, s.ps_max, -s.rank_min,
                        s.rank_max])
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        sm = self._vec([s.rank_mean, s.nonfinite_count, s.acc_nonfinite])
        dist.all_reduce(sm)
        hi, sm = hi.tolist(), sm.tolist()
        return ChainStats(
            tau_log_max=hi[0], ps_min=-hi[1], ps_max=hi[2],
            rank_min=-hi[3], rank_max=hi[4],
            rank_mean=sm[0] / self.world, nonfinite_count=sm[1],
            acc_nonfinite=sm[2])

    def total(self, x: float) -> float:
        """``x`` summed over the ranks (also a barrier)."""
        t = self._vec([x])
        dist.all_reduce(t)
        return t.item()

    def gather_ints(self, values) -> np.ndarray:
        """Every rank's integer vector ``values``: (world, len) int64, in
        rank order, on every rank (a pod resume's source signatures)."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64,
                         device=self.device)
        return self._every(t).cpu().numpy()

    def share(self, obj):
        """Rank 0's ``obj`` on every rank: a pod's replicated result.  Its
        tensors (bare, in lists and tuples, or a ChainCarry's) cross as
        host copies and land on this rank's device; what the other ranks
        pass is ignored."""
        box = [_map_tensors(obj, lambda t: t.cpu()) if self.rank == 0
               else None]
        dist.broadcast_object_list(
            box, src=0,
            device=self.device if self.device.type == "cuda" else None)
        if self.rank == 0:
            return obj
        return _map_tensors(box[0], lambda t: t.to(self.device))

    def decide(self, *flags: bool) -> tuple:
        """Rank 0's ``flags`` on every rank."""
        t = self._vec(flags)
        dist.broadcast(t, src=0)
        return tuple(bool(v) for v in t.tolist())

    def gather_counts(self, launches: dict, collectives: dict) -> list:
        """Every rank's kernel launch and sweep collective counts, in rank
        order (``[{name: count}]``), on every rank."""
        names = [*launches, *collectives]
        out = self._every(self._vec([*launches.values(),
                                     *collectives.values()]))
        return [dict(zip(names, (int(v) for v in row)))
                for row in out.tolist()]

    def gather_traces(self, traces: np.ndarray) -> np.ndarray:
        """This rank's chains' (c_loc, iters, 4) trace rows -> every
        chain's (C, iters, 4), in chain order (the rows of a chain are the
        same on all of its ranks: the trace's sums are all-reduced)."""
        if self.layout.rows == 1:
            return traces
        out = self._every(torch.from_numpy(traces).to(self.device))
        firsts = [r * self.layout.cols for r in range(self.layout.rows)]
        return torch.cat([out[i] for i in firsts]).cpu().numpy()

    def _gather_rows(self, t: torch.Tensor, axis: Optional[int]):
        """Every rank's ``t`` -> on rank 0, each chain row's global tensor
        (concatenated along ``axis`` in shard order; None: the row's first
        copy); None on the other ranks, which allocate nothing for it."""
        t, cols = t.contiguous(), self.layout.cols
        if self.rank != 0:
            dist.gather(t, None, dst=0)
            return None
        if axis == 0:       # straight into each row's tensor, no copy
            out = [t.new_empty((cols * t.shape[0], *t.shape[1:]))
                   for _ in range(self.layout.rows)]
            dist.gather(t, [c for o in out for c in o.chunk(cols)], dst=0)
            return out
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.gather(t, parts, dst=0)
        rows = [parts[r * cols:(r + 1) * cols]
                for r in range(self.layout.rows)]
        return [row[0] if axis is None else torch.cat(row, dim=axis)
                for row in rows]

    def gather_carries(self, carries: list, *,
                       pairs: bool = True) -> Optional[list]:
        """Every chain's global carry (all shards, all packed panels) on
        rank 0, in chain order, from each rank's carries of its chains;
        None on the other ranks.  ``pairs=False`` leaves the packed
        accumulators out (None: :meth:`fetch` has drained them)."""
        rows, c_loc = self.layout.rows, len(carries)
        out: list = [None] * (rows * c_loc)
        for i, carry in enumerate(carries):
            skip = (() if pairs
                    else (id(carry.sigma_acc), id(carry.sigma_sq_acc)))
            leaves = [[None] * rows if id(t) in skip
                      else self._gather_rows(t, ax)
                      for t, ax in zip(carry_tensors(carry),
                                       carry_shard_axes(carry), strict=True)]
            if self.rank == 0:
                for r in range(rows):
                    out[r * c_loc + i] = carry_like(
                        carry, [v[r] for v in leaves])
        return out if self.rank == 0 else None

    def _pool_rows(self, acc: torch.Tensor) -> Optional[torch.Tensor]:
        """``acc``, this rank's pair slice summed over its own chains in
        chain order, summed over the chain rows in row order, as the
        one-device fetch sums every chain, on the chain row 0 rank of its
        shard block (consumed: summed in place); None on the ranks of the
        other rows.  A packed grid holds one chain a row, so the rows fold
        in chain order."""
        lay = self.layout
        if lay.rows == 1:
            return acc
        if lay.row:
            dist.gather(acc, None, dst=lay.col, group=self._col)
            return None
        parts = [torch.empty_like(acc) for _ in range(lay.rows)]
        dist.gather(acc, parts, dst=lay.col, group=self._col)
        del acc
        for a in parts[1:]:
            parts[0] += a
        return parts[0]

    def _gather_pairs(self, t: torch.Tensor, keep: int):
        """Chain row 0's pair slices of ``t`` (a row-0 rank's, along axis
        0) -> on rank 0 the first ``keep`` of all of them, in pair order;
        None on the other ranks.  Sent as bytes (gloo has no bfloat16)."""
        t = t.contiguous()
        raw = t.view(torch.uint8)
        if self.rank:
            dist.gather(raw, None, dst=0, group=self._row)
            return None
        out = t.new_empty((self.layout.cols * t.shape[0], *t.shape[1:]))
        dist.gather(raw, [c.view(torch.uint8) for c in
                          out.chunk(self.layout.cols)], dst=0,
                    group=self._row)
        return out[:keep]

    def link_panels(self, acc: torch.Tensor, acc_sq: Optional[torch.Tensor],
                    inv_count, bessel, mode: str) -> Optional[tuple]:
        """The mesh's posterior panels for the link from ``acc`` (and the
        second moments ``acc_sq``, or None), each this rank's pair slice
        summed over its own chains: pooled over the chain rows
        (:meth:`_pool_rows`), scaled and cast for the link on each shard
        block's row 0 rank by runtime/fetch.fetch_prep and fetch_sd_prep
        (whose arithmetic is per panel, so a slice gives the one-device
        fetch's bytes), and the slices gathered to rank 0 in pair order,
        the padding past the g(g+1)/2 kept panels dropped.  Returns on
        rank 0 ``(mean, sd or None)`` as the one-device fetch forms them
        on its device - ``(int8 panels, scales)`` under quant8, else the
        link-dtype panels; None on the other ranks.  Consumes ``acc`` and
        ``acc_sq``.  Every rank calls it at the same place: the post-hoc
        fetch after the chain, and each streamed snapshot at its boundary,
        from the main thread."""
        lay = self.layout
        acc = self._pool_rows(acc)
        acc_sq = None if acc_sq is None else self._pool_rows(acc_sq)
        if acc is None:
            return None
        C, ql = lay.num_chains, lay.local_pairs
        keep = num_upper_pairs(lay.num_shards)
        mean = fetch_prep(acc, C, lay.num_shards, inv_count, mode, keep=ql)
        sd = (None if acc_sq is None
              else fetch_sd_prep(acc_sq, acc, C, inv_count, bessel, mode))
        del acc, acc_sq

        def gather(x):          # a link tensor, or (int8 panels, scales)
            if mode == "quant8":
                return tuple(self._gather_pairs(t, keep) for t in x)
            return self._gather_pairs(x, keep)

        mean = gather(mean)
        sd = None if sd is None else gather(sd)
        return None if self.rank else (mean, sd)

    def fetch(self, carries: list, inv_count, bessel, mode: str,
              want_sd: bool) -> Optional[tuple]:
        """The post-hoc fetch of the mesh's posterior panels
        (:meth:`link_panels`) from the carries' accumulators, which it
        consumes: each rank's chains are summed in place into the first
        chain's."""
        def summed(accs):
            for a in accs[1:]:
                accs[0] += a
            return accs[0]

        return self.link_panels(
            summed([c.sigma_acc for c in carries]),
            summed([c.sigma_sq_acc for c in carries]) if want_sd else None,
            inv_count, bessel, mode)

    def local_leaves(self, leaves: dict) -> dict:
        """A checkpoint's global leaves -> this rank's
        (:func:`local_leaves`): the scatter of a resume, from the one
        file."""
        return local_leaves(self.layout, leaves)

    # ---- the ranks' lives ------------------------------------------------

    def children_failed(self) -> list:
        """``(rank, exit code)`` of every started rank that exited with a
        failure (or was killed) so far."""
        out = []
        for r, p in enumerate(self.procs, start=1):
            try:
                p.wait(timeout=0.5)
            except subprocess.TimeoutExpired:
                continue
            if p.returncode != 0:
                out.append((r, p.returncode))
        return out

    def _error_text(self, r: int) -> str:
        path = os.path.join(self.tmpdir or "", f"rank{r}.err")
        try:
            with open(path) as f:
                return f.read().strip().splitlines()[-1]
        except (OSError, IndexError):
            return ""

    def failure(self, e: BaseException) -> Optional[MeshRankError]:
        """The typed error of a mesh that failed under rank 0's ``e``, or
        None when ``e`` is rank 0's own error (a refusal every rank
        raised alike, a failure of the chain itself)."""
        if type(e) is not RuntimeError and not isinstance(e, dist.DistError):
            return None
        dead = self.children_failed()
        text = str(e).lower()
        if not (dead or isinstance(e, dist.DistError) or "timed out" in text
                or "timeout" in text):
            return None
        parts = [f"rank {r} exited with code {code}"
                 + (f" ({txt})" if (txt := self._error_text(r)) else "")
                 for r, code in dead]
        return MeshRankError(
            f"the mesh fit over {self.world} ranks failed: "
            + ("; ".join(parts) if parts else "a collective failed")
            + f" (rank {self.rank}: {e})")

    def close(self, *, kill: bool = False) -> None:
        """Rank 0: wait for (or, with ``kill``, kill) every started rank,
        then leave the process group and remove the store.  A pod's rank
        keeps its process group (parallel/multihost.shutdown leaves it)."""
        for p in self.procs:
            if kill:
                p.kill()
            try:
                p.wait(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        if dist.is_initialized() and not self.pod:
            dist.destroy_process_group()
        if self.tmpdir:
            shutil.rmtree(self.tmpdir, ignore_errors=True)


def _map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to each of its tensors (bare, in lists
    and tuples, a ChainCarry's)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, ChainCarry):
        return carry_like(obj, [None if t is None else fn(t)
                                for t in carry_tensors(obj)])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    return obj


def _split_axis(name: str) -> tuple:
    """``(axis after the chain axis, "pairs" or "shards")`` along which
    the mesh splits checkpoint leaf ``name``; ``(None, None)`` for a leaf
    every rank of a chain holds whole."""
    if name in _PAIR_LEAVES:
        return 0, "pairs"
    if name in _RING_LEAVES:
        return 1, "shards"
    if name in _REPLICATED:
        return None, None
    return 0, "shards"


def block_slices(layout: RankLayout, name: str, shape: tuple) -> tuple:
    """The rank's block of the global checkpoint leaf ``name`` of
    ``shape`` (the chain-axis convention of C chains), as a tuple of
    slices: its chains, and its shards (or packed panels) along the axis
    the mesh splits."""
    out, lead = [], 0
    if layout.num_chains > 1:
        out.append(slice(layout.chains.start, layout.chains.stop))
        lead = 1
    rest = [slice(None)] * (len(shape) - lead)
    ax, kind = _split_axis(name)
    if ax is not None:
        lo, n = ((layout.pair_offset, layout.local_pairs) if kind == "pairs"
                 else (layout.shard_offset, layout.local_shards))
        rest[ax] = slice(lo, lo + n)
    return tuple(out + rest)


def local_leaves(layout: RankLayout, leaves: dict) -> dict:
    """A checkpoint's global leaves (the chain-axis convention of C
    chains) -> the rank's chains and block (the convention of its c_loc
    chains: no chain axis when it runs one)."""
    out = {}
    for k, a in leaves.items():
        a = np.asarray(a)
        a = a[block_slices(layout, k, a.shape)]
        if layout.num_chains > 1 and len(layout.chains) == 1:
            a = a[0]
        out[k] = a
    return out


def leaf_block(layout: RankLayout, name: str, local: np.ndarray) -> tuple:
    """A rank's block of the global checkpoint leaf ``name`` (the
    chain-axis convention of C chains): ``(block, origin, shape)``, where
    ``block`` is ``local`` (the convention of the rank's c_loc chains)
    with the global leaf's axes - a length-1 chain axis where the global
    leaf has one and the rank runs one chain - ``origin`` its first index
    in the global leaf and ``shape`` the global leaf's shape.
    :func:`local_leaves` takes this block out of a global leaf; a warm
    start grafts a donor's global leaf into it (runtime/resume.
    graft_block), and a pod's rank saves it at its origin
    (utils/checkpoint.save_checkpoint_multiprocess)."""
    block, origin, shape = np.asarray(local), [], []
    if layout.num_chains > 1:
        if len(layout.chains) == 1:
            block = block[None]
        origin.append(layout.chains.start)
        shape.append(layout.num_chains)
    rest = list(block.shape[len(origin):])
    rest_origin = [0] * len(rest)
    ax, kind = _split_axis(name)
    if ax is not None:
        if kind == "pairs":
            rest_origin[ax] = layout.pair_offset
            rest[ax] = num_padded_pairs(layout.num_shards)
        else:
            rest_origin[ax] = layout.shard_offset
            rest[ax] = layout.num_shards
    return block, tuple(origin + rest_origin), tuple(shape + rest)


def _init_group(device: torch.device, store_path: str, rank: int,
                world: int) -> None:
    if dist.is_initialized():
        raise RuntimeError(
            "a mesh fit needs its own torch.distributed process group, "
            "but this process already has one")
    kw = {}
    backend = "gloo"
    if device.type == "cuda":
        backend, kw["device_id"] = "nccl", device
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S),
        **kw)


def rank_device(device: torch.device, rank: int) -> torch.device:
    """Rank ``rank``'s device: on the GPU the ``rank``-th card from the
    caller's ``device`` (rank 0 runs where the caller asked), else the
    CPU."""
    return (torch.device("cuda", _first_card(device) + rank)
            if device.type == "cuda" else torch.device("cpu"))


def rank_block(data, layout: RankLayout):
    """The rank's (Gl, n, P) block of the fit's data: a slice of the
    array (a read-only mapping of the shared data file on a started
    rank), or read from a lazy source (utils/preprocess.LazyShardData)
    for its own shards only."""
    lo, hi = layout.shard_offset, layout.shard_offset + layout.local_shards
    if isinstance(data, np.ndarray):
        return np.array(data[lo:hi])
    return data.chunk(lo, hi)


@dataclasses.dataclass
class RankArgs:
    """What a started rank reads from its arguments file: its place, the
    rendezvous, the fit's rank job (api._RankJob) and the data - the path
    of the shared data file it maps, or a lazy source it reads its own
    shards from (never the (g, n, P) tensor itself)."""
    rank: int
    world: int
    parent: int
    device: str
    store_path: str
    tmpdir: str
    layout: RankLayout
    job: object
    data: object


def _die_with_parent(parent: int) -> None:
    try:
        prctl = ctypes.CDLL("libc.so.6", use_errno=True).prctl
        prctl.argtypes, prctl.restype = [ctypes.c_int, ctypes.c_ulong], \
            ctypes.c_int
        prctl(1, int(signal.SIGKILL))         # PR_SET_PDEATHSIG
    except OSError:     # no glibc: the collective timeout still bounds it
        pass
    if os.getppid() != parent:              # the caller is already gone
        os._exit(1)


def rank_main(path: str) -> None:
    """A started rank (``python -m dcfm_tpu_torch.parallel._rank ARGS``):
    join the group, run the rank's chain (api._run_rank), hand its
    carries to rank 0, leave.  A failure writes its traceback beside the
    store and exits 1; rank 0 reports it."""
    with open(path, "rb") as f:
        args: RankArgs = pickle.load(f)
    _die_with_parent(args.parent)
    torch.set_num_threads(1)
    try:
        device = torch.device(args.device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        data = args.data
        if isinstance(data, str):
            data = np.load(data, mmap_mode="r")
        _init_group(device, args.store_path, args.rank, args.world)
        mesh = RankMesh(args.layout, device)
        from dcfm_tpu_torch import api
        api._run_rank(args.job, mesh, rank_block(data, args.layout), device)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(args.tmpdir, f"rank{args.rank}.err"),
                  "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def start_mesh(world: int, device: torch.device, num_shards: int,
               num_chains: int, job, data) -> RankMesh:
    """Rank 0 (the caller): start ranks 1 .. ``world`` - 1 on ``job``,
    each a fresh interpreter (``data``, a (g, n, P) array, is written once
    to a file of the mesh's temporary directory that every rank maps; a
    lazy source goes as it is), join the group with them and return rank
    0's mesh."""
    layouts = [make_layout(world, r, num_shards, num_chains)
               for r in range(world)]
    tmpdir = tempfile.mkdtemp(prefix="dcfm-mesh-")
    store_path = os.path.join(tmpdir, "store")
    procs = []
    try:
        if world > 1 and isinstance(data, np.ndarray):
            np.save(os.path.join(tmpdir, "data.npy"), data)
            data = os.path.join(tmpdir, "data.npy")
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [pkg_root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                          else []))
        # fault plans address the caller's process only
        for k in [k for k in env if k.startswith("DCFM_FAULT_")]:
            del env[k]
        for r in range(1, world):
            path = os.path.join(tmpdir, f"rank{r}.args")
            with open(path, "wb") as f:
                pickle.dump(RankArgs(
                    rank=r, world=world, parent=os.getpid(),
                    device=str(rank_device(device, r)),
                    store_path=store_path, tmpdir=tmpdir, layout=layouts[r],
                    job=job, data=data), f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "dcfm_tpu_torch.parallel._rank",
                 path], env=env, stdin=subprocess.DEVNULL))
        _init_group(rank_device(device, 0), store_path, 0, world)
        mesh = RankMesh(layouts[0], rank_device(device, 0))
    except BaseException:
        for p in procs:
            p.kill()
            p.wait()
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmpdir, ignore_errors=True)
        raise
    mesh.procs, mesh.tmpdir = procs, tmpdir
    return mesh


# -- trace-gate registrations (analysis/tracecheck.py) --------------------
#
# Rank 0's second trip on a representative layout, its RankMesh built
# while the gate's stand-in collectives run (tracecheck.fake_collectives:
# group tokens, no process group): the gate checks every group the
# sweep's reduce_fn / gather_fn name against the rank's chain row.

def _mesh_trip_spec(device: str, layout: RankLayout, *,
                    pod: bool = False) -> TraceSpec:
    from dcfm_tpu_torch.config import ModelConfig
    from dcfm_tpu_torch.models.sampler import trace_runner, trace_trip

    cfg = ModelConfig(num_shards=layout.num_shards, factors_per_shard=3,
                      rho=0.8)
    mesh = RankMesh(layout, torch.device(device), pod=pod)
    runner = trace_runner(device, cfg, layout.local_shards, mesh=mesh)
    return TraceSpec(fn=trace_trip(runner, layout.chains[0]),
                     device=device, mesh=layout, pod=pod,
                     carry=lambda: carry_tensors(runner.carry),
                     static_key=(cfg, layout, runner.unroll))


@register_trace_entry("parallel.mesh_chunk", sweep_body=True)
def _trace_mesh_chunk(device: str) -> TraceSpec:
    # one chain over a row of 2 ranks (the JAX package's 1-D shard mesh)
    return _mesh_trip_spec(device, make_layout(2, 0, 4, 1))


@register_trace_entry("parallel.packed_chunk", sweep_body=True)
def _trace_packed_chunk(device: str) -> TraceSpec:
    # 2 chains packed as 2 rows of 2 ranks (chains x shards): the sweep's
    # collectives stay inside the chain row, never its column group
    return _mesh_trip_spec(device, make_layout(4, 0, 4, 2))


@register_trace_entry("parallel.pod_chunk", sweep_body=True)
def _trace_pod_chunk(device: str) -> TraceSpec:
    # a 2-host pod, one rank a host: the sweep's collectives span both
    # hosts' ranks of the row, never one host's part of it (DCFM1808)
    from dcfm_tpu_torch.parallel.mesh import make_pod_layout
    return _mesh_trip_spec(device, make_pod_layout(2, 0, 4, 1), pod=True)
