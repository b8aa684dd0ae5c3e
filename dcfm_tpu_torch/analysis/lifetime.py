"""DCFM12xx - host-buffer lifetime checking (the shipped UAF class).

Three of this repo's worst shipped bugs were one pattern: a host numpy
buffer (np.load result, np.memmap page, a view into either) aliased
zero-copy into the device runtime - through a jit entry point,
``jax.device_put``, or ``jax.make_array_from_callback`` - and then
freed while the (asynchronous) device computation still read it.
PR 1's resume SIGSEGV, PR 5's multiprocess-resume NaN Sigma, and PR 6's
stream-drain re-pin were all this shape; the shipped fix is always the
same: commit through an owned copy (``_owned_copy_jit`` /
``_copy_tree`` / ``np.ascontiguousarray``) while the source is alive.

This checker encodes that contract once, as an intraprocedural-plus-
one-call dataflow pass:

* **taint sources** (function-local only - parameters and attributes
  are the caller's problem, which is what keeps
  ``parallel.multihost.place_sharded_global`` quiet): ``np.load`` /
  ``np.memmap`` / ``np.fromfile`` / ``np.lib.format.open_memmap``
  results, ``with np.load(...) as z`` names, and calls to *loader
  helpers* - functions (same module, or project-wide via the engine's
  symbol table) whose return value is itself tainted;
* **taint propagation**: subscripts/attribute reads/views of tainted
  values (``.base``-bearing views die with their base), tuple unpacks,
  ``np.asarray`` (which does NOT copy);
* **cleansing**: binding through an owned-copy call
  (``ascontiguousarray``, ``np.array`` without ``copy=False``,
  ``np.copy``, ``.copy()``, anything whose name contains ``owned_copy``
  or ``copy_tree``) makes the RESULT clean; the source stays tainted;
* **sinks**: a tainted value handed to a jit entry point (jit-decorated
  def, a name bound from ``jax.jit(...)``, or a project-known jit),
  ``jax.device_put``, or closed over / defaulted into the callback of
  ``jax.make_array_from_callback``;
* **sanction by commit**: a sink is forgiven when the same function
  performs an owned-copy call at or after the sink line - the
  checkpoint.py shape: build aliased arrays page by page, then
  ``return _copy_tree(carry), meta`` commits the whole tree while the
  pages are still alive.  (Jit callees whose own name contains "copy"
  ARE the commit and are never sinks.)

The port's copy of ``dcfm_tpu/analysis/lifetime.py``: the same code, so the
same findings on the same source (held finding for finding by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import ast
from typing import Optional

_NP_SOURCE_TAILS = {"load", "memmap", "fromfile", "frombuffer"}
_CLEANSE_TAILS = {"ascontiguousarray", "copy", "deepcopy"}
# np heads after alias resolution ("np" resolves to "numpy")
_NP_HEADS = {"numpy"}


def _last(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _is_np_source(mod, call: ast.Call) -> bool:
    full = mod.resolve(call.func)
    if not full:
        return False
    head = full.split(".", 1)[0]
    if head in _NP_HEADS and _last(full) in _NP_SOURCE_TAILS:
        return True
    return full == "numpy.lib.format.open_memmap"


def _is_cleanse(mod, call: ast.Call) -> bool:
    full = mod.resolve(call.func)
    tail = _last(full)
    if "owned_copy" in full or "copy_tree" in full:
        return True
    if tail in _CLEANSE_TAILS:
        return True
    if full == "numpy.array":
        # np.array copies by default; copy=False opts back into aliasing
        for k in call.keywords:
            if (k.arg == "copy" and isinstance(k.value, ast.Constant)
                    and k.value.value is False):
                return False
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr == "copy":
        return True
    return False


class _FnTaint:
    """Taint + sink analysis for one function body."""

    def __init__(self, mod, fdef, returners: set, jit_names: set,
                 project=None):
        self.mod = mod
        self.fdef = fdef
        self.returners = returners        # local fn names returning taint
        self.jit_names = jit_names        # local jit-entry names
        self.project = project
        self.taints: dict = {}            # name -> (provenance, line)
        self.cleanse_lines: list = []
        self._local_defs: dict = {
            st.name: st for st in ast.walk(fdef)
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef))
            and st is not fdef}
        self._analyze()

    # -- taint computation --------------------------------------------
    def _expr_taint(self, node) -> Optional[tuple]:
        """(provenance, line) if this expression is tainted."""
        if isinstance(node, ast.Name):
            return self.taints.get(node.id)
        if isinstance(node, (ast.Subscript, ast.Attribute, ast.Starred)):
            return self._expr_taint(node.value)
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                t = self._expr_taint(e)
                if t is not None:
                    return t
            return None
        if isinstance(node, ast.IfExp):
            return (self._expr_taint(node.body)
                    or self._expr_taint(node.orelse))
        if isinstance(node, ast.Call):
            if _is_cleanse(self.mod, node):
                return None
            if _is_np_source(self.mod, node):
                full = self.mod.resolve(node.func)
                return (f"{full} at line {node.lineno}", node.lineno)
            full = self.mod.resolve(node.func)
            tail = _last(full)
            if (full in self.returners or tail in self.returners
                    or (self.project is not None
                        and full in getattr(self.project,
                                            "tainted_returners", ()))):
                return (f"loader helper {tail}() at line {node.lineno}",
                        node.lineno)
            # taint flows through view-producing methods on tainted
            # receivers: arr.reshape(...), arr.view(...), np.asarray(arr)
            if tail in {"asarray", "atleast_1d", "atleast_2d", "ravel",
                        "reshape", "view", "transpose", "squeeze"}:
                for a in list(node.args) + [k.value for k in
                                            node.keywords]:
                    t = self._expr_taint(a)
                    if t is not None:
                        return t
                if isinstance(node.func, ast.Attribute):
                    return self._expr_taint(node.func.value)
            return None
        return None

    def _analyze(self) -> None:
        # forward dataflow in source order, iterated to a fixed point
        # (a helper defined below its caller still taints correctly);
        # rebinding a name through a cleanse call CLEARS its taint -
        # `carry = _owned_copy_jit(carry)` is the before-the-sink
        # commit idiom, the after-the-sink one is self.cleanse_lines
        stmts = [n for n in ast.walk(self.fdef)
                 if isinstance(n, (ast.Assign, ast.AnnAssign, ast.With))]
        stmts.sort(key=lambda n: (n.lineno, n.col_offset))
        for _ in range(3):
            changed = False
            for st in stmts:
                if isinstance(st, ast.With):
                    for item in st.items:
                        if (item.optional_vars is not None
                                and isinstance(item.context_expr, ast.Call)
                                and _is_np_source(self.mod,
                                                  item.context_expr)):
                            full = self.mod.resolve(
                                item.context_expr.func)
                            changed |= self._taint_target(
                                item.optional_vars,
                                (f"with {full} at line "
                                 f"{item.context_expr.lineno} (dies at "
                                 "with-exit)",
                                 item.context_expr.lineno))
                    continue
                if st.value is None:
                    continue
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                t = self._expr_taint(st.value)
                if t is not None:
                    for tgt in targets:
                        changed |= self._taint_target(tgt, t)
                elif isinstance(st.value, ast.Call) and _is_cleanse(
                        self.mod, st.value):
                    for tgt in targets:
                        if (isinstance(tgt, ast.Name)
                                and tgt.id in self.taints):
                            del self.taints[tgt.id]
            if not changed:
                break
        for st in ast.walk(self.fdef):
            if isinstance(st, ast.Call) and _is_cleanse(self.mod, st):
                self.cleanse_lines.append(st.lineno)

    def _taint_target(self, tgt, t) -> bool:
        changed = False
        if isinstance(tgt, ast.Name):
            if tgt.id not in self.taints:
                self.taints[tgt.id] = t
                changed = True
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for e in tgt.elts:
                changed |= self._taint_target(e, t)
        elif isinstance(tgt, ast.Starred):
            changed |= self._taint_target(tgt.value, t)
        return changed

    def returns_tainted(self) -> bool:
        for st in ast.walk(self.fdef):
            if isinstance(st, ast.Return) and st.value is not None:
                if self._expr_taint(st.value) is not None:
                    return True
        return False

    # -- sinks ---------------------------------------------------------
    def _sanctioned(self, line: int) -> bool:
        return any(cl >= line for cl in self.cleanse_lines)

    def _callback_taint(self, cb) -> Optional[tuple]:
        """Taint captured by a make_array_from_callback callback: free
        names and default-argument expressions of a lambda or local def."""
        if isinstance(cb, ast.Name) and cb.id in self._local_defs:
            cb = self._local_defs[cb.id]
        if isinstance(cb, (ast.Lambda, ast.FunctionDef,
                           ast.AsyncFunctionDef)):
            args = cb.args
            bound = {a.arg for a in (args.posonlyargs + args.args
                                     + args.kwonlyargs)}
            for d in args.defaults + [d for d in args.kw_defaults
                                      if d is not None]:
                t = self._expr_taint(d)
                if t is not None:
                    return t
            body = cb.body if isinstance(cb.body, list) else [cb.body]
            for st in body:
                for n in ast.walk(st):
                    if (isinstance(n, ast.Name) and n.id not in bound
                            and n.id in self.taints):
                        return self.taints[n.id]
            return None
        return self._expr_taint(cb)

    def find_sinks(self, rep) -> None:
        project_jits = (getattr(self.project, "jit_entries", set())
                        if self.project is not None else set())
        for n in ast.walk(self.fdef):
            if not isinstance(n, ast.Call):
                continue
            full = self.mod.resolve(n.func)
            tail = _last(full)
            if tail == "make_array_from_callback" and n.args:
                t = self._callback_taint(n.args[-1])
                if t is not None and not self._sanctioned(n.lineno):
                    rep.emit(
                        "DCFM1201", n,
                        f"host buffer ({t[0]}) is captured by this "
                        "make_array_from_callback callback with no "
                        "owned-copy commit afterwards - the device "
                        "reads the aliased pages asynchronously, and "
                        "if the source dies first this is the PR-5 "
                        "use-after-free; commit the result through "
                        "_copy_tree/_owned_copy_jit while the source "
                        "is alive")
                continue
            is_jit_call = (
                tail in self.jit_names or full in self.jit_names
                or full in project_jits)
            is_device_put = full == "jax.device_put"
            if not (is_jit_call or is_device_put):
                continue
            if "copy" in tail:
                continue                  # the commit itself
            for a in list(n.args) + [k.value for k in n.keywords]:
                t = self._expr_taint(a)
                if t is None:
                    continue
                if self._sanctioned(n.lineno):
                    continue
                what = ("jax.device_put" if is_device_put
                        else f"jit entry {tail}()")
                rep.emit(
                    "DCFM1201", n,
                    f"host buffer ({t[0]}) flows into {what} with no "
                    "owned-copy commit - CPU-backend ingestion aliases "
                    "the buffer zero-copy and reads it asynchronously; "
                    "if the source dies first this is the PR-1/PR-6 "
                    "use-after-free; commit through _owned_copy_jit / "
                    "np.ascontiguousarray while the source is alive")
                break


def _module_jit_names(mod) -> set:
    """Names that are jit entry points in this module: jit-decorated
    defs plus ``name = jax.jit(...)`` bindings."""
    out = {f.name for f in mod.traced
           if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            if _last(mod.resolve(n.value.func)) in {"jit", "pjit"}:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def _local_returners(mod, jit_names: set, project=None) -> set:
    """Fixed point: module functions whose return value is tainted.

    Pruned for speed (this runs per file, per pass, over the whole
    tree): a function with no value-bearing ``return`` can never be a
    returner, and after the first pass only functions that CALL a
    newly-discovered returner can change verdict."""
    returners: set = set()
    info = []
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        has_ret = False
        called: set = set()
        for n in ast.walk(fdef):
            if isinstance(n, ast.Return) and n.value is not None:
                has_ret = True
            elif isinstance(n, ast.Call):
                called.add(_last(mod.resolve(n.func)))
        info.append((fdef, has_ret, called))
    fresh: Optional[set] = None       # None = first pass: analyze all
    for _ in range(4):
        added: set = set()
        for fdef, has_ret, called in info:
            if not has_ret or fdef.name in returners:
                continue
            if fresh is not None and not (called & fresh):
                continue
            fa = _FnTaint(mod, fdef, returners, jit_names, project)
            if fa.returns_tainted():
                returners.add(fdef.name)
                added.add(fdef.name)
        if not added:
            break
        fresh = added
    return returners


def collect_lifetime_summary(mod, module_dotted: str) -> dict:
    """Engine symbol-table contribution for one module: dotted names of
    tainted-returning loader helpers and of module-level jit entries."""
    jit_names = _module_jit_names(mod)
    returners = _local_returners(mod, jit_names)
    return {
        "tainted_returners": sorted(
            f"{module_dotted}.{r}" for r in returners),
        "jit_entries": sorted(
            f"{module_dotted}.{j}" for j in jit_names),
    }


def _has_sink_call(mod, fdef, jit_names: set, project_jits: set) -> bool:
    """Cheap pre-scan: does this function contain any call that could
    be a DCFM1201 sink?  Most functions don't, and skipping the full
    taint analysis for them is what keeps whole-tree lint fast."""
    for n in ast.walk(fdef):
        if not isinstance(n, ast.Call):
            continue
        full = mod.resolve(n.func)
        tail = _last(full)
        if tail == "make_array_from_callback" or full == "jax.device_put":
            return True
        if tail in jit_names or full in jit_names or full in project_jits:
            return True
    return False


def check_lifetime(mod, rep, project=None) -> None:
    jit_names = _module_jit_names(mod)
    returners = _local_returners(mod, jit_names, project)
    project_jits = (getattr(project, "jit_entries", set())
                    if project is not None else set())
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _has_sink_call(mod, fdef, jit_names, project_jits):
            continue
        fa = _FnTaint(mod, fdef, returners, jit_names, project)
        fa.find_sinks(rep)
