"""Trace-entry registry: the entries the port's trace gate verifies.

The port of ``dcfm_tpu/analysis/registry.py``.  Library modules register
their graphed entry points here (a decorator over a lazy *builder*
function), and analysis/tracecheck.py runs each one once on real tensors
of a representative size under a recording ``TorchDispatchMode`` and
checks the recorded aten ops for the DCFM18xx invariants.  The registry
itself is dependency-free - importing it imports no torch and runs
nothing; all cost is deferred to the builder call inside the gate.

A builder takes the device (``"cpu"`` or ``"cuda"``) and returns a
:class:`TraceSpec`: a zero-argument callable that runs the entry once
(everything it needs - state, pre-drawn variates, a runner's first trip
- already built), the device, the compute dtype, the mesh layout (a
``parallel/mesh.RankLayout``, or None, and whether it is a pod's), a
callable giving the carry tensors the entry must write in place, and the
entry's static key.  Builders that cannot run in
the current environment raise :class:`SkipEntry`, which the gate reports
as a skip, not a failure.

The test fixtures register deliberately-broken entries under a
``fixture.`` name prefix; :func:`discover` imports the library's
registration modules and, by default, returns only entries defined
inside the dcfm_tpu_torch package - so an imported fixture module can
never contaminate the whole-registry run.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
from typing import Any, Callable, Optional, Tuple


class SkipEntry(Exception):
    """Raised by a builder whose representative environment is
    unavailable."""


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """What one entry runs: built lazily by the registered builder."""
    fn: Callable[[], Any]                  # runs the entry once
    device: str = "cpu"                    # "cpu" | "cuda"
    compute_dtype: str = "f32"             # "f32" | "bf16"
    mesh: Any = None                       # parallel/mesh.RankLayout
    pod: bool = False                      # mesh from make_pod_layout
    # () -> the carry tensors the entry must write in place (read before
    # and after it runs), or None
    carry: Optional[Callable[[], Any]] = None
    static_key: Tuple[Any, ...] = ()       # the entry's static key


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    name: str
    build: Callable[[str], TraceSpec]
    path: str                              # defining module file
    line: int                              # registration line (finding anchor)
    sweep_body: bool = False               # no variate, no chains crossed


_REGISTRY: dict = {}

# Modules whose import populates the library's registrations.  Kept as
# dotted names (not imported here) so the registry module stays inert.
_LIBRARY_MODULES = (
    "dcfm_tpu_torch.models.conditionals",
    "dcfm_tpu_torch.models.sampler",
    "dcfm_tpu_torch.runtime.fetch",
    "dcfm_tpu_torch.parallel.shard",
)


def register_trace_entry(name: str, *, sweep_body: bool = False):
    """Decorator: register ``build_fn`` as the lazy builder for entry
    ``name``.  Re-registration under the same name replaces (module
    reloads in tests must not accumulate duplicates)."""
    def deco(build_fn):
        try:
            path = os.path.abspath(inspect.getsourcefile(build_fn) or "")
            line = build_fn.__code__.co_firstlineno
        except (TypeError, AttributeError):
            path, line = "", 0
        _REGISTRY[name] = TraceEntry(name=name, build=build_fn, path=path,
                                     line=line, sweep_body=sweep_body)
        return build_fn
    return deco


def entries() -> dict:
    """The raw registry (name -> TraceEntry), already-imported only."""
    return dict(_REGISTRY)


def get(name: str) -> TraceEntry:
    return _REGISTRY[name]


def discover(library_only: bool = True) -> list:
    """Import the library registration modules and return the entries,
    sorted by name.  ``library_only`` keeps only entries whose builder
    is defined inside the dcfm_tpu_torch package - the fixture isolation
    the whole-registry run relies on."""
    import importlib

    for mod in _LIBRARY_MODULES:
        importlib.import_module(mod)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for e in _REGISTRY.values():
        if library_only and not e.path.startswith(pkg_root + os.sep):
            continue
        out.append(e)
    return sorted(out, key=lambda e: e.name)


class TraceKeyRegistry:
    """Retrace sentinel: records each entry's static key and flags
    components that would defeat a cache keyed on it.

    A graph (or a build) keyed on the static key is looked up again when
    the key changes, and the key must therefore be (a) hashable and (b)
    value-stable across calls and processes.  Two component classes
    break that:

    * **unhashable** containers (list/dict/set/bytearray/ndarray) -
      TypeError at the lookup, or worse, an ad-hoc ``str()``
      work-around that aliases distinct states;
    * **identity-hashed** mutable objects (a class instance inheriting
      ``object.__hash__``) - the key is the object's address, so every
      fresh construction MISSES the cache (a silent rebuild per call)
      and a mutated-in-place instance falsely HITS it.

    Frozen dataclasses, strings, numbers, and tuples thereof are the
    sanctioned key vocabulary.
    """

    def __init__(self):
        self._keys: dict = {}

    def record(self, name: str, key: Tuple[Any, ...]) -> list:
        """Record ``key`` for entry ``name``; return a list of
        (component_index, reason) problems (empty when stable)."""
        self._keys[name] = key
        problems = []
        for i, comp in enumerate(key):
            reason = _unstable_reason(comp)
            if reason:
                problems.append((i, reason))
        return problems

    def keys(self) -> dict:
        return dict(self._keys)


def _unstable_reason(comp: Any) -> Optional[str]:
    """Why ``comp`` is unsafe as a static-key component, or None."""
    if isinstance(comp, (list, dict, set, bytearray)):
        return (f"{type(comp).__name__} is unhashable mutable state - "
                "freeze it (tuple / frozen dataclass) before keying")
    try:
        hash(comp)
    except TypeError:
        return (f"{type(comp).__name__} is unhashable - the cache "
                "lookup itself would raise")
    if dataclasses.is_dataclass(comp) and not comp.__dataclass_params__.frozen:
        return (f"non-frozen dataclass {type(comp).__name__} hashes by "
                "identity - mutation falsely HITS the cache, fresh "
                "construction silently rebuilds")
    if (type(comp).__hash__ is object.__hash__
            and type(comp).__eq__ is object.__eq__):
        return (f"{type(comp).__name__} hashes by object identity - "
                "every fresh construction misses the cache (a silent "
                "per-call rebuild) and in-place mutation falsely hits it")
    return None
