"""Trace-level analyzer: aten-op invariants over registered entries.

The port of ``dcfm_tpu/analysis/tracecheck.py``.  The AST linter
(analysis/linter.py) sees source text; the invariants the CUDA graphs
depend on live below it, in the ops an entry dispatches.  This module
runs each registered entry (analysis/registry.py) once, on real tensors
of a representative size, under a recording ``TorchDispatchMode`` that
notes each aten op's name and its tensors' dtypes, devices and shapes -
never a value: no ``.item()``, no printing, because on the card the
sweep-body entries run inside a CUDA graph capture, as a trip does
(its kernels counted into the capture's ``cuda_lib.capture_tally``).
The ChainRunner's own captures can run under the same recorder
(:func:`record`, :func:`check_recording`).  It checks the DCFM18xx rule
family on what was recorded:

* **collective groups** (DCFM1801/1802/1808): every collective the
  entry issues - the mesh's seam ``parallel/shard.RankMesh.reduce_fn`` /
  ``gather_fn`` - names the rank's chain row, never a column group that
  spans chains, and in a pod layout never one host's part of the row.
  The collectives are recorded by stand-ins for ``torch.distributed``'s
  (:func:`fake_collectives`): no process group is started, the mesh's
  groups are tokens carrying their ranks, an all-reduce keeps the local
  sum and an all-gather tiles the local block.
* **dtype leaks** (DCFM1803/1804): no float64 tensor anywhere and no
  bfloat16 in an f32 entry; in a bf16 entry no matmul-family op outputs
  bfloat16 or float16 (``models/conditionals.mm_bf16``'s float32 output).
* **host syncs** (DCFM1805): no ``_local_scalar_dense`` / ``item``, no
  copy from a device tensor to a CPU one, no op whose output shape
  depends on the data.
* **in-place carry** (DCFM1806): every declared carry tensor keeps its
  storage across the entry - the graphs replay into the static carry.
* **retrace sentinel** (DCFM1807): the entry's static key through
  :class:`~dcfm_tpu_torch.analysis.registry.TraceKeyRegistry`.
* **variates** (DCFM1809): no random aten op in a sweep-body entry, and
  no CUDA event recorded or waited on by the thread running it.

Findings are ordinary :class:`~dcfm_tpu_torch.analysis.linter.Finding`
rows anchored at each entry's *registration line*, so the severity
tiers, SARIF serialization and LINT_BASELINE.json fingerprinting all
apply unchanged.  ``python -m dcfm_tpu_torch.analysis --trace`` is the
CLI (``--device cuda``, the default, or ``cpu``); the per-entry results
are cached on the defining module's content hash, and ``--changed``
skips entries whose defining module matches git HEAD.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import threading
import time
from typing import Callable, Iterable, Optional

from dcfm_tpu_torch.analysis.linter import Finding
from dcfm_tpu_torch.analysis.registry import (
    SkipEntry, TraceEntry, TraceKeyRegistry, discover)
from dcfm_tpu_torch.analysis.rules import TRACE_RULES

# the aten ops (overload packets) each rule reads
_RANDOM_OPS = frozenset({
    "normal", "normal_", "uniform", "uniform_", "exponential",
    "exponential_", "bernoulli", "bernoulli_", "random", "random_",
    "randn", "randn_like", "rand", "rand_like", "randint", "randint_like",
    "randperm", "multinomial", "poisson", "_standard_gamma",
    "_sample_dirichlet", "binomial", "cauchy_", "log_normal_",
    "geometric_"})
_SYNC_OPS = frozenset({"_local_scalar_dense", "item"})
_DATA_SHAPED_OPS = frozenset({
    "nonzero", "masked_select", "unique", "_unique", "_unique2",
    "unique_dim", "unique_consecutive"})
_MATMUL_OPS = frozenset({"mm", "bmm", "addmm", "baddbmm", "matmul",
                         "addbmm", "dot", "mv", "addmv"})
_LOWP_DTYPES = ("torch.bfloat16", "torch.float16")

# torch.distributed's data-moving collectives, stood in for while an
# entry is built and run (fake_collectives)
_COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
                "reduce_scatter_tensor", "broadcast", "gather", "scatter",
                "reduce", "all_to_all_single")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched aten op: its name (``aten.mm.default``), overload
    packet (``mm``) and its tensors' (dtype, device type, shape)."""
    name: str
    packet: str
    ins: tuple
    outs: tuple


@dataclasses.dataclass(frozen=True)
class Group:
    """A process group of the stand-in collectives: the ranks it spans."""
    ranks: tuple


@dataclasses.dataclass
class Recording:
    """What one run of an entry dispatched."""
    ops: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    events: list = dataclasses.field(default_factory=list)


def _metas(tree) -> tuple:
    import torch
    from torch.utils._pytree import tree_flatten

    leaves, _ = tree_flatten(tree)
    return tuple((str(t.dtype), t.device.type, tuple(t.shape))
                 for t in leaves if isinstance(t, torch.Tensor))


def _recorder(rec: Recording):
    """A TorchDispatchMode appending each op to ``rec.ops`` (its inputs
    before it runs, so an op that raises is still on record)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            i = len(rec.ops)
            rec.ops.append(OpRecord(str(func), func.overloadpacket.__name__,
                                    _metas((args, kwargs)), ()))
            out = func(*args, **kwargs)
            rec.ops[i] = dataclasses.replace(rec.ops[i], outs=_metas(out))
            return out
    return _Mode()


@contextlib.contextmanager
def _event_calls(rec: Recording):
    """Note every ``torch.cuda.Event.record`` / ``wait`` and
    ``torch.cuda.Stream.record_event`` / ``wait_event`` made by this
    thread while the block runs (``Stream.wait_stream`` is the latter
    two)."""
    import torch

    me = threading.get_ident()
    saved = []
    for cls, names in ((torch.cuda.Event, ("record", "wait")),
                       (torch.cuda.Stream, ("record_event", "wait_event"))):
        for name in names:
            real = cls.__dict__.get(name)
            if real is None:
                continue

            def wrapped(*a, _real=real, _what=f"{cls.__name__}.{name}",
                        **kw):
                if threading.get_ident() == me:
                    rec.events.append(_what)
                return _real(*a, **kw)
            saved.append((cls, name, real))
            setattr(cls, name, wrapped)
    try:
        yield
    finally:
        for cls, name, real in saved:
            setattr(cls, name, real)


@contextlib.contextmanager
def record(rec: Optional[Recording] = None):
    """Record the ops and the CUDA event calls of the block into a
    :class:`Recording` (yielded).  Safe inside a CUDA graph capture: it
    reads metadata only."""
    rec = Recording() if rec is None else rec
    with _event_calls(rec), _recorder(rec):
        yield rec


@contextlib.contextmanager
def fake_collectives():
    """Stand-ins for ``torch.distributed``'s group creation and
    collectives while the block runs: ``new_group`` returns a
    :class:`Group` token, each collective appends ``(name, group)`` to
    the yielded list (``group`` None: the whole world) and moves no data
    between processes - an all-reduce leaves the local sum, the seam's
    ``all_gather_into_tensor`` fills its output with copies of the local
    block, the others leave their outputs as they were.  No process group
    exists or is started."""
    import torch.distributed as dist
    from torch.utils._python_dispatch import _disable_current_modes

    log: list = []
    saved = {name: getattr(dist, name, None)
             for name in ("new_group", *_COLLECTIVES)}

    def new_group(ranks=None, *a, **kw):
        return Group(tuple(int(r) for r in (ranks or ())))

    def collective(name):
        def fn(*a, group=None, **kw):
            log.append((name, group))
            if name == "all_gather_into_tensor":
                # the seam's gather; the stand-in's copy is not the entry's
                with _disable_current_modes():
                    a[0].view(-1, *a[1].shape).copy_(a[1])
            return None
        return fn

    dist.new_group = new_group
    for name in _COLLECTIVES:
        setattr(dist, name, collective(name))
    try:
        yield log
    finally:
        for name, fn in saved.items():
            if fn is None:
                delattr(dist, name)
            else:
                setattr(dist, name, fn)


_CAPTURE_STREAMS: dict = {}


def _captured(fn: Callable[[], object], device) -> dict:
    """Run ``fn`` inside a CUDA graph capture (thread-local error mode,
    the cyclic collector off, on one side stream per card), as the
    ChainRunner captures a trip; return the capture's kernel tally.  The
    graph is dropped unreplayed."""
    import gc

    import torch

    from dcfm_tpu_torch.ops import cuda_lib

    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with cuda_lib.capture_tally() as tally:
            with torch.cuda.graph(graph, stream=_CAPTURE_STREAMS[index],
                                  capture_error_mode="thread_local"):
                fn()
    finally:
        if collecting:
            gc.enable()
    del graph
    return dict(tally)


# -- the rules on a recording ------------------------------------------

def _group_ranks(group, layout) -> Optional[tuple]:
    """The ranks ``group`` spans (None: a group the mesh never made)."""
    if group is None:
        return tuple(range(layout.world))
    if isinstance(group, Group):
        return group.ranks
    return None


def check_recording(rec: Recording, *, compute_dtype: str = "f32",
                    sweep_body: bool = False, mesh=None,
                    pod: bool = False) -> list:
    """``(rule, message)`` for every violation in ``rec``: DCFM1801-1805
    and 1808-1809 (1800, 1806 and 1807 need the entry's run, carry and
    key: :func:`check_entry`)."""
    out = []
    bf16_mode = compute_dtype == "bf16"
    leaked: dict = {}                   # dtype -> (tensors, first op)
    for op in rec.ops:
        metas = op.ins + op.outs
        for dt, _dev, _shape in metas:
            if dt == "torch.float64" or (dt == "torch.bfloat16"
                                         and not bf16_mode):
                n, first = leaked.get(dt, (0, op.name))
                leaked[dt] = (n + 1, first)
        if bf16_mode and op.packet in _MATMUL_OPS:
            low = sorted({dt for dt, _, _ in op.outs if dt in _LOWP_DTYPES})
            if low:
                out.append((
                    "DCFM1804",
                    f"{op.name} outputs {'/'.join(low)} - the product "
                    "rounds its output to the low precision; accumulate "
                    "and return float32 (models/conditionals.mm_bf16: "
                    "out_dtype=torch.float32 on the card)"))
        if op.packet in _SYNC_OPS:
            out.append(("DCFM1805",
                        f"{op.name} reads a tensor's value on the host "
                        "inside the trip"))
        elif op.packet in _DATA_SHAPED_OPS:
            out.append(("DCFM1805",
                        f"{op.name}'s output shape depends on the data: "
                        "the host waits for the device to size it"))
        elif (any(dev == "cuda" for _, dev, _ in op.ins)
              and any(dev == "cpu" for _, dev, _ in op.outs)):
            out.append(("DCFM1805",
                        f"{op.name} copies a device tensor to the host "
                        "inside the trip"))
        if sweep_body and op.packet in _RANDOM_OPS:
            out.append(("DCFM1809",
                        f"{op.name} draws a variate inside the trip - a "
                        "CUDA graph replays its Philox offsets; draw it "
                        "before the trip (noise.draw_into) and read it "
                        "from BufferedDraws"))
    for dt, (n, first) in sorted(leaked.items()):
        why = ("nothing of the chain is float64" if dt == "torch.float64"
               else "the compute_dtype default must run the pre-knob "
                    "float32 program exactly")
        out.append(("DCFM1803",
                    f"{n} {dt.split('.')[1]} tensor(s) (the first at "
                    f"{first}) in a {compute_dtype} entry - {why}"))
    if sweep_body:
        for what in rec.events:
            out.append(("DCFM1809",
                        f"{what} called by the thread running the trip - "
                        "an event inside a capture invalidates it; order "
                        "streams before or after the trip"))
    if mesh is not None:
        row = set(mesh.row_ranks(mesh.row))
        for name, group in rec.collectives:
            ranks = _group_ranks(group, mesh)
            where = f"{name} over {group!r}"
            if ranks is None:
                out.append(("DCFM1801",
                            f"{where}: a group the mesh never made - the "
                            f"chain row's is ranks {sorted(row)}"))
                continue
            rows = {r // mesh.cols for r in ranks}
            if sweep_body and len(rows) > 1:
                out.append(("DCFM1802",
                            f"{where} spans chain rows {sorted(rows)} "
                            "inside a sweep body - chains must stay "
                            "independent during the sweep; reduce over "
                            "the chain row's group"))
            elif set(ranks) == row:
                continue
            elif sweep_body and pod and set(ranks) < row:
                out.append(("DCFM1808",
                            f"{where} spans one host's part {list(ranks)} "
                            f"of the chain row {sorted(row)} in a pod - "
                            "the sweep's cross-host collectives span the "
                            "whole row"))
            else:
                out.append(("DCFM1801",
                            f"{where} spans ranks {list(ranks)}, not the "
                            f"chain row's {sorted(row)}"))
    return out


# -- per-entry verification ---------------------------------------------

@dataclasses.dataclass
class EntryResult:
    """One entry's gate: its findings, its op count, its collectives by
    name, its seconds, the kernel tally of its capture (card sweep
    bodies) and why it was skipped (or None)."""
    findings: list
    ops: int = 0
    collectives: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0
    tally: Optional[dict] = None
    skipped: Optional[str] = None


def trace_entry(entry: TraceEntry, device: str = "cpu",
                key_registry: Optional[TraceKeyRegistry] = None
                ) -> EntryResult:
    """Build ``entry`` on ``device`` and run it once under the recorder
    (inside a CUDA graph capture for a sweep body on the card)."""
    import torch

    def finding(rule: str, message: str) -> Finding:
        return Finding(entry.path, entry.line, 0, rule,
                       f"[{entry.name}] {message}")

    t0 = time.perf_counter()
    with fake_collectives() as log:
        try:
            spec = entry.build(device)
        except SkipEntry as e:
            return EntryResult([], skipped=str(e) or "skipped")
        except Exception as e:
            return EntryResult([finding(
                "DCFM1800",
                f"entry builder failed: {type(e).__name__}: {e}")],
                seconds=time.perf_counter() - t0)
        del log[:]
        carry = list(spec.carry()) if spec.carry is not None else []
        before = [t.data_ptr() for t in carry]
        rec, tally, findings = Recording(), None, []
        dev = torch.device(spec.device)
        try:
            if dev.type == "cuda" and entry.sweep_body:
                def run():
                    with record(rec):
                        spec.fn()
                tally = _captured(run, dev)
            else:
                with record(rec):
                    spec.fn()
        except Exception as e:
            findings.append(finding(
                "DCFM1800",
                f"the entry failed under the recorder: "
                f"{type(e).__name__}: {e}"))
        rec.collectives = list(log)
    findings += [finding(rule, msg) for rule, msg in check_recording(
        rec, compute_dtype=spec.compute_dtype, sweep_body=entry.sweep_body,
        mesh=spec.mesh, pod=spec.pod)]

    after = [t.data_ptr() for t in spec.carry()] \
        if spec.carry is not None else []
    moved = sum(1 for a, b in zip(before, after) if a != b) + abs(
        len(after) - len(before))
    if moved:
        findings.append(finding(
            "DCFM1806",
            f"{moved} of {len(before)} carry tensor(s) do not keep their "
            "storage across the entry - a graph replays into the static "
            "carry in place; write results with copy_ / in-place ops"))

    if key_registry is None:
        key_registry = TraceKeyRegistry()
    shapes_sig = tuple((tuple(t.shape), str(t.dtype)) for t in carry)
    mesh_sig = (dataclasses.astuple(spec.mesh) if spec.mesh is not None
                else ())
    full_key = tuple(spec.static_key) + (shapes_sig, mesh_sig)
    for idx, reason in key_registry.record(entry.name, full_key):
        findings.append(finding(
            "DCFM1807",
            f"static key component #{idx} "
            f"({type(full_key[idx]).__name__}) is unstable: {reason}"))
    issued: dict = {}
    for name, _ in rec.collectives:
        issued[name] = issued.get(name, 0) + 1
    return EntryResult(findings, ops=len(rec.ops), collectives=issued,
                       seconds=time.perf_counter() - t0, tally=tally)


def check_entry(entry: TraceEntry,
                key_registry: Optional[TraceKeyRegistry] = None,
                device: str = "cpu") -> list:
    """All findings for one registered entry (empty when it verifies);
    a builder raising SkipEntry yields no findings."""
    return trace_entry(entry, device, key_registry).findings


def check_entries(entry_list: Iterable[TraceEntry],
                  device: str = "cpu") -> list:
    """Findings over a list of entries, sorted like the AST engine's."""
    key_registry = TraceKeyRegistry()
    findings = []
    for entry in entry_list:
        findings.extend(check_entry(entry, key_registry, device))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# -- project gate: discovery + content-hash cache + --changed ---------

def _trace_rules_digest() -> str:
    blob = json.dumps(sorted(
        (r.id, r.name, r.family, r.summary, r.severity)
        for r in TRACE_RULES.values()))
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def _version_stamp(device: str) -> str:
    import torch

    from dcfm_tpu_torch.analysis.engine import ENGINE_VERSION
    return (f"trace:{ENGINE_VERSION}:{_trace_rules_digest()}:"
            f"{torch.__version__}:{device}")


def _load_cache(cache_path: Optional[str], device: str) -> dict:
    if not cache_path:
        return {}
    try:
        with open(cache_path, "r", encoding="utf-8") as f:
            data = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(data, dict) \
            or data.get("version") != _version_stamp(device):
        return {}
    ent = data.get("entries")
    return ent if isinstance(ent, dict) else {}


def _save_cache(cache_path: Optional[str], entries: dict,
                device: str) -> None:
    if not cache_path:
        return
    import tempfile
    d = os.path.dirname(os.path.abspath(cache_path)) or "."
    try:
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tracecache-",
                                   suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({"version": _version_stamp(device),
                       "entries": entries}, f)
        os.replace(tmp, cache_path)
    except OSError:
        pass                          # cache is an optimization, never fatal


def _module_sha(path: str) -> Optional[str]:
    try:
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()
    except OSError:
        return None


def check_project(*, cache_path: Optional[str] = None,
                  changed_only: bool = False,
                  root: Optional[str] = None, device: str = "cpu",
                  report: Optional[Callable] = None) -> list:
    """The whole-registry trace gate: discover the library's entries,
    verify each on ``device`` (content-hash cached per defining module),
    and return Finding rows.  With ``changed_only``, entries whose
    defining module matches git HEAD are skipped entirely - the AST
    engine's --changed contract applied per entry.  ``report(name,
    result)`` is called per entry with its :class:`EntryResult` (None
    when the cache answered)."""
    root = os.path.abspath(root or os.getcwd())

    entry_list = discover()

    if changed_only:
        from dcfm_tpu_torch.analysis.engine import _changed_files
        changed = _changed_files(root)
        if changed is None:
            raise RuntimeError(
                "--changed needs a usable git checkout at "
                f"{root} (git diff/ls-files failed)")
        entry_list = [e for e in entry_list if e.path in changed]

    cache = _load_cache(cache_path, device)
    new_cache: dict = {}
    key_registry = TraceKeyRegistry()
    findings = []
    for entry in entry_list:
        sha = _module_sha(entry.path)
        hit = cache.get(entry.name)
        if sha is not None and hit and hit.get("sha") == sha \
                and "findings" in hit:
            rows = [Finding(*row) for row in hit["findings"]]
            result = None
        else:
            result = trace_entry(entry, device, key_registry)
            rows = result.findings
        if report is not None:
            report(entry.name, result)
        new_cache[entry.name] = {
            "sha": sha,
            "findings": [[f.path, f.line, f.col, f.rule, f.message]
                         for f in rows]}
        findings.extend(rows)
    _save_cache(cache_path, new_cache, device)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
