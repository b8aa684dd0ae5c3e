"""DCFM12xx - host-buffer lifetime checking (the shipped UAF class).

Three of the JAX package's worst shipped bugs were one pattern: a host
numpy buffer (np.load result, np.memmap page, a view into either)
aliased zero-copy into the device runtime and then freed while the
(asynchronous) device work still read it.  The port's spelling of the
same hazard: ``torch.from_numpy`` / ``torch.as_tensor`` alias the numpy
buffer (no copy on the CPU), and an asynchronous device copy of that
alias (``.to(dev, non_blocking=True)``, ``.copy_(src,
non_blocking=True)``, ``.cuda(non_blocking=True)``, ``.pin_memory()``)
reads it after the call returns; or the alias escapes the ``with
np.load(...)`` block whose file it came from.  The fix is always the
same: commit through an owned copy (``.clone()``, ``np.array`` /
``.copy()``, ``torch.tensor``) while the source is alive.

This checker encodes that contract once, as an intraprocedural-plus-
one-call dataflow pass:

* **taint sources** (function-local only - parameters and attributes
  are the caller's problem): ``np.load`` / ``np.memmap`` /
  ``np.fromfile`` / ``np.frombuffer`` / ``np.lib.format.open_memmap``
  results, ``with np.load(...) as z`` names, and calls to *loader
  helpers* - functions (same module, or project-wide via the engine's
  symbol table) whose return value is itself tainted;
* **taint propagation**: subscripts/attribute reads/views of tainted
  values, tuple unpacks, ``np.asarray`` (which does NOT copy), and the
  zero-copy bridges ``torch.from_numpy`` / ``torch.as_tensor`` /
  ``torch.frombuffer``;
* **cleansing**: binding through an owned-copy call (``.clone()``,
  ``np.array`` without ``copy=False``, ``np.copy``, ``.copy()``,
  ``torch.tensor``, anything whose name contains ``owned_copy`` or
  ``copy_tree``) makes the RESULT clean; the source stays tainted.
  ``np.ascontiguousarray`` of a contiguous array is the array itself,
  so only ``np.ascontiguousarray`` of a copy is one;
* **sinks**: an asynchronous device copy of a tainted value, or a
  tainted tensor of ``with np.load`` provenance returned or stored on
  an attribute (it outlives its source);
* **sanction by commit**: a sink is forgiven when the same function
  performs an owned-copy call at or after the sink line (build aliased
  tensors, then commit the whole tree while the pages are alive).
"""

from __future__ import annotations

import ast
from typing import Optional

_NP_SOURCE_TAILS = {"load", "memmap", "fromfile", "frombuffer"}
_CLEANSE_TAILS = {"copy", "deepcopy", "clone"}
# zero-copy bridges from a numpy buffer to a tensor
_BRIDGES = {"torch.from_numpy", "torch.as_tensor", "torch.frombuffer"}
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
    if full == "torch.tensor":
        return True
    if full == "numpy.array":
        # np.array copies by default; copy=False opts back into aliasing
        for k in call.keywords:
            if (k.arg == "copy" and isinstance(k.value, ast.Constant)
                    and k.value.value is False):
                return False
        return True
    if isinstance(call.func, ast.Attribute) and call.func.attr in (
            "copy", "clone"):
        return True
    return False


class _FnTaint:
    """Taint + sink analysis for one function body.  A taint is
    ``(provenance, line, tensor, scoped)``: ``tensor`` once it crossed a
    zero-copy bridge into a tensor, ``scoped`` when its source dies at
    a ``with`` exit."""

    def __init__(self, mod, fdef, returners: set, project=None):
        self.mod = mod
        self.fdef = fdef
        self.returners = returners        # local fn names returning taint
        self.project = project
        self.taints: dict = {}            # name -> taint
        self.cleanse_lines: list = []
        self._analyze()

    # -- taint computation --------------------------------------------
    def _expr_taint(self, node) -> Optional[tuple]:
        """The taint of this expression, or None."""
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
            full = self.mod.resolve(node.func)
            if _is_np_source(self.mod, node):
                return (f"{full} at line {node.lineno}", node.lineno,
                        False, False)
            tail = _last(full)
            if (full in self.returners or tail in self.returners
                    or (self.project is not None
                        and full in getattr(self.project,
                                            "tainted_returners", ()))):
                return (f"loader helper {tail}() at line {node.lineno}",
                        node.lineno, False, False)
            # taint flows through the zero-copy bridges and through
            # view-producing methods on tainted receivers:
            # torch.from_numpy(arr), arr.reshape(...), np.asarray(arr)
            if full in _BRIDGES and node.args:
                t = self._expr_taint(node.args[0])
                return None if t is None else (t[0], t[1], True, t[3])
            if tail in {"asarray", "atleast_1d", "atleast_2d", "ravel",
                        "reshape", "view", "transpose", "squeeze",
                        "flatten", "contiguous", "unsqueeze", "permute",
                        "expand", "narrow", "select", "view_as"}:
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
        # `leaf = leaf.clone()` is the before-the-sink commit idiom,
        # the after-the-sink one is self.cleanse_lines
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
                                 item.context_expr.lineno, False, True))
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
            if self.taints.get(tgt.id) != t and (
                    tgt.id not in self.taints or t[2]):
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

    def _emit(self, rep, node, t, what) -> None:
        if not self._sanctioned(node.lineno):
            rep.emit(
                "DCFM1201", node,
                f"host buffer ({t[0]}) {what} with no owned-copy commit - "
                "torch.from_numpy / torch.as_tensor alias the numpy "
                "pages, so if the source dies (or is rewritten) before "
                "the card reads them this is the JAX package's PR-1/PR-6 "
                "use-after-free; commit through .clone() / np.array / "
                "torch.tensor while the source is alive")

    def find_sinks(self, rep) -> None:
        for n in ast.walk(self.fdef):
            if isinstance(n, ast.Call):
                f = n.func
                if not isinstance(f, ast.Attribute):
                    continue
                async_kw = any(
                    k.arg == "non_blocking"
                    and isinstance(k.value, ast.Constant)
                    and k.value.value is True for k in n.keywords)
                if f.attr == "pin_memory" or (
                        async_kw and f.attr in ("to", "cuda")):
                    t = self._expr_taint(f.value)
                    if t is not None:
                        self._emit(rep, n, t,
                                   f"reaches an asynchronous device copy "
                                   f"(.{f.attr}(...))")
                elif async_kw and f.attr == "copy_" and n.args:
                    t = self._expr_taint(n.args[0])
                    if t is not None:
                        self._emit(rep, n, t,
                                   "is the source of an asynchronous "
                                   ".copy_(..., non_blocking=True)")
            elif isinstance(n, ast.Return) and n.value is not None:
                t = self._expr_taint(n.value)
                if t is not None and t[2] and t[3]:
                    self._emit(rep, n, t, "is returned as a tensor that "
                               "outlives its with-block")
            elif isinstance(n, ast.Assign) and any(
                    isinstance(tg, (ast.Attribute, ast.Subscript))
                    for tg in n.targets):
                t = self._expr_taint(n.value)
                if t is not None and t[2] and t[3]:
                    self._emit(rep, n, t, "is stored as a tensor that "
                               "outlives its with-block")


def _local_returners(mod, project=None) -> set:
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
            fa = _FnTaint(mod, fdef, returners, project)
            if fa.returns_tainted():
                returners.add(fdef.name)
                added.add(fdef.name)
        if not added:
            break
        fresh = added
    return returners


def collect_lifetime_summary(mod, module_dotted: str) -> dict:
    """Engine symbol-table contribution for one module: dotted names of
    its tainted-returning loader helpers."""
    returners = _local_returners(mod)
    return {"tainted_returners": sorted(
        f"{module_dotted}.{r}" for r in returners)}


def _has_sink_site(fdef) -> bool:
    """Cheap pre-scan: could this function hold a DCFM1201 sink (an
    asynchronous copy, a pin, or a ``with`` whose alias may escape)?
    Most functions can't, and skipping the full taint analysis for
    them is what keeps whole-tree lint fast."""
    for n in ast.walk(fdef):
        if isinstance(n, ast.With):
            return True
        if isinstance(n, ast.Call) and (
                any(k.arg == "non_blocking" for k in n.keywords)
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr == "pin_memory")):
            return True
    return False


def check_lifetime(mod, rep, project=None) -> None:
    returners = _local_returners(mod, project)
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not _has_sink_site(fdef):
            continue
        _FnTaint(mod, fdef, returners, project).find_sinks(rep)
