"""AST linter core: torch/FFI-aware checks over one module at a time.

Design: one :func:`lint_source` pass per file, no imports of the linted
code (pure ``ast``), no third-party dependencies.  Each rule family is a
separate checker over a shared :class:`_Module` context that pre-resolves
the things every family needs:

* import aliases (``torch``/``np``/``dist``/``ctypes`` may be bound to
  anything; the checkers work on *resolved* dotted names),
* the set of **captured regions** - the port's counterpart of JAX's
  traced functions: the body of a ``with torch.cuda.graph(...)`` block,
  a callable given to ``torch.cuda.make_graphed_callables``, and the
  entry (``TraceSpec(fn=...)``) of a builder registered with
  ``register_trace_entry(..., sweep_body=True)``, plus every function
  such a region calls - in this module, and through the engine's
  cross-module symbol table (analysis/engine.py) in the others,
* CDLL-tainted names for the FFI family (values flowing out of
  ``ctypes.CDLL`` through module globals and local helper returns).

False-positive posture: every rule errs toward silence.  The gate is
``dcfm-tpu-torch lint --gate`` exiting 0, so a rule that cries wolf on
sanctioned idioms (a dtype guard, a shape test in a captured function,
the host-side float64 of a test oracle) would be deleted, not argued
with.

Fifteen rules are the JAX package's detectors unchanged (the meta, FFI,
thread, server, robustness, telemetry, handler, lockset, poll-loop and
pointer rules: the same findings on the same source, held by
tests/test_torch_analysis.py); the other fifteen keep the JAX ids,
families, severities and scopes and match the torch spelling of the
hazard (tests/test_torch_lint_rules.py).  A port-only suppression is
written ``# dcfm-torch: ignore[RULE] - <why>``, which the JAX linter does
not read; this linter reads that form and the JAX one.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Optional

from dcfm_tpu_torch.analysis.rules import ALL_RULES, RULES, TRANSLATED

# the JAX linter's pragma, and the port's own (invisible to the JAX one)
_IGNORE_RE = re.compile(r"#\s*dcfm:\s*ignore\[([A-Z0-9, ]+)\]")
_TORCH_IGNORE_RE = re.compile(r"#\s*dcfm-torch:\s*ignore\[([A-Z0-9, ]+)\]")

# torch functions that draw from a stream: without generator= (or with
# generator=None) they draw from the process-global one
_TORCH_VARIATES = {
    "randn", "rand", "randint", "randperm", "normal", "poisson",
    "bernoulli", "multinomial", "binomial", "rand_like", "randn_like",
    "randint_like", "_standard_gamma", "_sample_dirichlet",
}
# in-place tensor methods that fill from a stream
_INPLACE_VARIATES = {
    "normal_", "uniform_", "exponential_", "bernoulli_", "random_",
    "cauchy_", "log_normal_", "geometric_",
}
_SEED_METHODS = {"manual_seed", "manual_seed_all"}

_CONTIG_PRODUCERS = {"ascontiguousarray", "require", "zeros", "empty",
                     "ones", "full", "zeros_like", "empty_like",
                     "ones_like", "full_like"}

# methods that copy a tensor's values to the host (or wait for the card)
_HOST_SYNC_METHODS = {"item", "tolist", "tobytes", "cpu", "numpy"}
_HOST_SYNC_NP = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray",
                 "numpy.copy"}
# torch calls whose result size or Python value depends on the data
_HOST_SYNC_TORCH = {"torch.cuda.synchronize", "torch.nonzero",
                    "torch.argwhere", "torch.equal"}

# tensor metadata: fixed when a graph is captured, so a test on it is
# static structure, not a captured value
_META_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "is_cpu",
               "layout", "requires_grad", "is_sparse", "is_leaf", "names",
               "itemsize", "nbytes", "type"}
_META_METHODS = {"size", "dim", "numel", "nelement", "ndimension", "stride",
                 "element_size", "data_ptr", "is_contiguous",
                 "is_floating_point", "is_complex", "get_device",
                 "storage_offset", "untyped_storage", "is_pinned", "item",
                 "tolist", "type"}
# builtins whose result is a host value (a count, a flag, a container)
_HOST_BUILTINS = {"len", "isinstance", "issubclass", "int", "float", "bool",
                  "str", "repr", "format", "type", "id", "hash", "getattr",
                  "hasattr", "callable", "range", "list", "tuple", "dict",
                  "set", "frozenset", "enumerate", "zip", "sorted", "print"}
# torch functions that return no tensor
_TORCH_HOST_TAILS = {"is_tensor", "is_floating_point", "is_complex",
                     "get_default_dtype", "is_grad_enabled", "Size",
                     "device", "dtype", "finfo", "iinfo", "result_type",
                     "promote_types", "broadcast_shapes", "can_cast",
                     "is_storage", "Generator", "is_inference_mode_enabled"}
_TORCH_HOST_PREFIXES = ("torch.cuda.", "torch.backends.", "torch.autograd.",
                        "torch.distributed.", "torch.profiler.")

@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def __str__(self) -> str:
        name = (ALL_RULES[self.rule].name
                if self.rule in ALL_RULES else "error")
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{name}] {self.message}")


def _dotted(node: ast.AST) -> Optional[str]:
    """'torch.cuda.graph' for Attribute/Name chains, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _last(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def module_dotted(path: str) -> str:
    """Dotted module name for the cross-module symbol table: the file's
    stem under every enclosing directory that holds an ``__init__.py``
    (``dcfm_tpu_torch/models/sampler.py`` ->
    ``dcfm_tpu_torch.models.sampler``; a file outside a package keys by
    its stem - scripts cannot be imported cross-module anyway)."""
    ap = os.path.abspath(path)
    d, base = os.path.split(ap)
    stem = base[:-3] if base.endswith(".py") else base
    parts = [] if stem == "__init__" else [stem]
    while os.path.isfile(os.path.join(d, "__init__.py")):
        d, pkg = os.path.split(d)
        parts.insert(0, pkg)
        if not pkg:
            break
    return ".".join(parts)


_DEFS = (ast.FunctionDef, ast.AsyncFunctionDef)
# the symbol-table key of "a call of field NAME on an object of unknown
# type" (engine.Project maps it to the defs published under NAME)
ATTR_CALL = "attr:"


class _Module:
    """Shared per-file context: aliases, captured regions, taint.

    ``project`` is the optional cross-module symbol table built by
    analysis/engine.py (threaded classes, loader helpers, the functions
    a capture reaches); single-file mode (``lint_file`` without a
    project) keeps every rule functional on in-module evidence alone.
    """

    def __init__(self, tree: ast.Module, source: str, path: str,
                 project=None):
        self.tree = tree
        self.path = path
        self.project = project
        self.lines = source.splitlines()
        base = os.path.basename(path)
        self.is_test = base.startswith("test_") or base == "conftest.py"
        # Runtime pipeline module (DCFM801 scope): a file living under a
        # directory named "runtime" (dcfm_tpu_torch/runtime/), or whose
        # stem is "runtime" / ends in "_runtime" (the lint-fixture naming
        # convention).  Deliberately NOT a substring match: a module
        # like runtime_flags.py is ordinary library code and must not
        # be held to the pipeline's async-fetch discipline.
        parts = str(path).replace("\\", "/").split("/")
        stem = base[:-3] if base.endswith(".py") else base
        self.is_runtime = ("runtime" in parts[:-1] or stem == "runtime"
                           or stem.endswith("_runtime"))
        # the process-group seam (DCFM1701 scope): parallel/
        self.is_parallel = "parallel" in parts[:-1]
        # Standalone scripts (scripts/, bench.py, the graft driver) are
        # operator entry points, not library code: library_only rules
        # (constant seeds, console prints, daemon helpers) skip them
        # exactly like test files - the whole-tree gate must not force
        # telemetry discipline onto demo drivers.
        self.is_script = ("scripts" in parts[:-1]
                          or stem in {"bench", "__graft_entry__"})
        self.dotted = module_dotted(path)
        self.pragmas: list = []
        self.ignores = self._collect_ignores()
        self.aliases: dict = {}
        self._collect_aliases()
        self._collect_defs()
        # captured regions: FunctionDef / Lambda / With nodes
        self.traced: set = set()
        # dotted names outside this module that a captured region calls
        self.traced_external: set = set()
        self._collect_traced()

    def _collect_ignores(self) -> dict:
        """Pragmas from real COMMENT tokens only: a docstring or rule
        summary that merely *mentions* the ``# dcfm: ignore[...]``
        syntax is prose, not a suppression (and must not be flagged as
        a stale one by DCFM002).  Both forms are read; ``self.pragmas``
        keeps each one's form for the staleness check."""
        out: dict = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO("\n".join(self.lines) + "\n").readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            for form, regex in (("dcfm", _IGNORE_RE),
                                ("dcfm-torch", _TORCH_IGNORE_RE)):
                m = regex.search(tok.string)
                if not m:
                    continue
                rules = {r.strip() for r in m.group(1).split(",")}
                out.setdefault(tok.start[0], set()).update(rules)
                self.pragmas.append((tok.start[0],
                                     tok.start[1] + m.start(), form,
                                     rules))
        return out

    def _collect_aliases(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.aliases[a.asname or a.name] = (
                        f"{node.module}.{a.name}")

    def resolve(self, node: ast.AST) -> str:
        """Canonical dotted name of an expression ('' if unresolvable):
        the head segment is expanded through the import aliases, so
        ``import torch.distributed as dist`` makes ``dist.barrier``
        resolve to ``torch.distributed.barrier``."""
        name = _dotted(node)
        if not name:
            return ""
        head, _, rest = name.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    # -- the def tree ---------------------------------------------------
    def _collect_defs(self) -> None:
        """One linear traversal: every def keyed by its enclosing def
        scope (the module for top-level functions), methods by their
        class, each node's innermost enclosing def, and the dotted name
        of every top-level function and top-level class method (the
        cross-module symbol table's keys)."""
        self._scope_defs: dict = {self.tree: {}}
        self._parent: dict = {}
        self._class_of: dict = {}
        self._classes: dict = {}
        self._class_by_name: dict = {}
        self._owner: dict = {}
        self.dotted_of: dict = {}

        def walk(node, scope, cls, cls_top):
            for child in ast.iter_child_nodes(node):
                self._owner[id(child)] = scope
                if isinstance(child, _DEFS):
                    if cls is not None:
                        self._classes[cls][child.name] = child
                        self._class_of[child] = cls
                        if cls_top:
                            self.dotted_of[child] = (
                                f"{self.dotted}.{cls.name}.{child.name}")
                    else:
                        self._scope_defs[scope][child.name] = child
                        if scope is self.tree:
                            self.dotted_of[child] = (
                                f"{self.dotted}.{child.name}")
                        elif scope in self.dotted_of:
                            self.dotted_of[child] = (
                                f"{self.dotted_of[scope]}.{child.name}")
                    self._parent[child] = scope
                    self._scope_defs[child] = {}
                    walk(child, child, None, False)
                elif isinstance(child, ast.ClassDef):
                    self._classes[child] = {}
                    top = scope is self.tree and cls is None
                    if top:
                        self._class_by_name[child.name] = child
                    walk(child, scope, child, top)
                else:
                    walk(child, scope, cls, cls_top)

        walk(self.tree, self.tree, None, False)
        self._methods_named: dict = {}
        for meths in self._classes.values():
            for name, d in meths.items():
                self._methods_named.setdefault(name, []).append(d)
        self._published = self._collect_published()

    def _collect_published(self) -> dict:
        """Defs of this module handed to a constructor as a named field
        - ``Prior(name, init, update, ...)`` of a NamedTuple defined
        here, or any ``f(update=fn)`` - keyed by the field name: a later
        ``prior.update(...)`` on an object of unknown type may run them
        (the priors' closures that gibbs_sweep calls)."""
        out: dict = {}
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            pairs = [(k.arg, k.value) for k in node.keywords if k.arg]
            if (isinstance(node.func, ast.Name)
                    and node.func.id in self._class_by_name):
                cls = self._class_by_name[node.func.id]
                fields = [st.target.id for st in cls.body
                          if isinstance(st, ast.AnnAssign)
                          and isinstance(st.target, ast.Name)]
                pairs += list(zip(fields, node.args))
            where = self._owner.get(id(node))
            for attr, v in pairs:
                if isinstance(v, ast.Name):
                    d = self._lookup(v.id, where)
                    if d is not None:
                        out.setdefault(attr, set()).add(d)
        return out

    def published(self) -> dict:
        """:meth:`_collect_published` as dotted names, for the engine."""
        return {attr: sorted(self.dotted_of[d] for d in defs
                             if d in self.dotted_of)
                for attr, defs in self._published.items()}

    def _lookup(self, name: str, where) -> Optional[ast.AST]:
        """The def ``name`` visible from scope ``where`` (its own nested
        defs, then each enclosing def scope, then the module)."""
        scope = where
        while scope is not None:
            d = self._scope_defs.get(scope, {}).get(name)
            if d is not None:
                return d
            scope = self._parent.get(scope)
        return None

    def _enclosing_class(self, where) -> Optional[ast.ClassDef]:
        scope = where
        while scope is not None and scope is not self.tree:
            if scope in self._class_of:
                return self._class_of[scope]
            scope = self._parent.get(scope)
        return None

    def callees(self, func: ast.AST, where) -> tuple:
        """(defs of this module, dotted names elsewhere) that a call of
        ``func`` made in scope ``where`` may run.  Method calls resolve
        on ``self``/``cls``, on a class of this module, or - for a
        private method name that exactly one class here defines - on any
        receiver (``runner._sweeps``)."""
        if isinstance(func, ast.Lambda):
            return {func}, set()
        if isinstance(func, ast.Name):
            d = self._lookup(func.id, where)
            if d is not None:
                return {d}, set()
            full = self.resolve(func)
            return set(), ({full} if full != func.id else set())
        if not isinstance(func, ast.Attribute):
            return set(), set()
        recv = func.value
        if isinstance(recv, ast.Name):
            if recv.id in ("self", "cls"):
                cls = self._enclosing_class(where)
                d = self._classes.get(cls, {}).get(func.attr)
                return ({d} if d is not None else set()), set()
            if recv.id in self._class_by_name:
                d = self._classes[self._class_by_name[recv.id]].get(
                    func.attr)
                return ({d} if d is not None else set()), set()
            if recv.id in self.aliases:
                return set(), {self.resolve(func)}
        if func.attr.startswith("_") and not func.attr.startswith("__"):
            cands = self._methods_named.get(func.attr, [])
            if len(cands) == 1:
                return {cands[0]}, set()
        # a field call on an object of unknown type: the defs published
        # under that field name, here and (through the engine) elsewhere
        return (set(self._published.get(func.attr, ())),
                {f"{ATTR_CALL}{func.attr}"})

    def _callable_targets(self, expr: ast.AST, where) -> tuple:
        """What a callable-valued expression runs when called: a lambda,
        a def, a ``functools.partial`` of one, or the lambdas / defs a
        local factory returns (``fn=trace_trip(runner)``)."""
        if isinstance(expr, (ast.Tuple, ast.List)):
            local, ext = set(), set()
            for e in expr.elts:
                lo, ex = self._callable_targets(e, where)
                local |= lo
                ext |= ex
            return local, ext
        if isinstance(expr, ast.Call):
            if _last(self.resolve(expr.func)) == "partial" and expr.args:
                return self._callable_targets(expr.args[0], where)
            local, _ = self.callees(expr.func, where)
            out: set = set()
            for factory in local:
                if not isinstance(factory, _DEFS):
                    continue
                for r in ast.walk(factory):
                    if isinstance(r, ast.Return) and r.value is not None:
                        lo, _ = self._callable_targets(r.value, factory)
                        out |= lo
            return out, set()
        return self.callees(expr, where)

    # -- captured regions -----------------------------------------------
    def _collect_traced(self) -> None:
        roots: set = set()
        builders: list = []
        for node in ast.walk(self.tree):
            if isinstance(node, ast.With) and any(
                    isinstance(it.context_expr, ast.Call)
                    and self.resolve(it.context_expr.func)
                    == "torch.cuda.graph" for it in node.items):
                roots.add(node)
            elif (isinstance(node, ast.Call) and node.args
                  and _last(self.resolve(node.func))
                  == "make_graphed_callables"):
                lo, ex = self._callable_targets(
                    node.args[0], self._owner.get(id(node)))
                roots |= lo
                self.traced_external |= ex
            elif isinstance(node, _DEFS) and any(
                    isinstance(dec, ast.Call)
                    and _last(self.resolve(dec.func))
                    == "register_trace_entry"
                    and any(k.arg == "sweep_body"
                            and isinstance(k.value, ast.Constant)
                            and k.value.value is True
                            for k in dec.keywords)
                    for dec in node.decorator_list):
                builders.append(node)
        # a sweep-body builder's entry: the fn= of the TraceSpec it (or a
        # helper of this module it calls) builds - what the gate runs as
        # a trip; the builder's own set-up runs eagerly before it
        seen: set = set()
        while builders:
            b = builders.pop()
            if b in seen:
                continue
            seen.add(b)
            for n in ast.walk(b):
                if not isinstance(n, ast.Call):
                    continue
                where = self._owner.get(id(n))
                if _last(self.resolve(n.func)) == "TraceSpec":
                    for k in n.keywords:
                        if k.arg == "fn":
                            lo, ex = self._callable_targets(k.value, where)
                            roots |= lo
                            self.traced_external |= ex
                else:
                    lo, _ = self.callees(n.func, where)
                    builders.extend(d for d in lo if isinstance(d, _DEFS))
        if self.project is not None:
            known = getattr(self.project, "traced", ())
            roots |= {d for d, name in self.dotted_of.items()
                      if name in known}
        self._propagate(roots)

    def _propagate(self, roots: set) -> None:
        """Close the captured set over calls: every def a region calls,
        in this module; calls leaving the module go to traced_external
        (the engine closes those over the other modules)."""
        frontier = list(roots - self.traced)
        self.traced |= roots
        while frontier:
            region = frontier.pop()
            where = region if isinstance(region, _DEFS) else \
                self._owner.get(id(region))
            for n in region_nodes(region, ()):
                if not isinstance(n, ast.Call):
                    continue
                lo, ex = self.callees(n.func, self._owner.get(id(n), where))
                self.traced_external |= ex
                for d in lo - self.traced:
                    self.traced.add(d)
                    frontier.append(d)

    def call_edges(self) -> dict:
        """Cross-module call graph contribution: for every top-level
        function and method, the dotted names of what it may call
        (nested defs and lambdas included)."""
        out: dict = {}
        for fdef, name in self.dotted_of.items():
            callees: set = set()
            for n in ast.walk(fdef):
                if not isinstance(n, ast.Call):
                    continue
                lo, ex = self.callees(n.func, self._owner.get(id(n), fdef))
                callees |= ex
                callees |= {self.dotted_of[d] for d in lo
                            if d in self.dotted_of}
            if callees:
                out[name] = sorted(callees)
        return out

    def reexports(self) -> dict:
        """Names this module binds by ``from x import y`` at its top
        level, as the dotted names they stand for (a package's
        ``__init__`` re-exporting a function)."""
        out: dict = {}
        for node in self.tree.body:
            if isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                for a in node.names:
                    out[f"{self.dotted}.{a.asname or a.name}"] = (
                        f"{node.module}.{a.name}")
        return out


def region_nodes(region: ast.AST, traced) -> Iterable[ast.AST]:
    """The nodes a captured region runs: a def's body, a lambda's body,
    a ``with`` block's statements; nested defs and classes are their own
    regions (walked only when they are in ``traced`` themselves)."""
    if isinstance(region, ast.With):
        stack = list(reversed(region.body))
    elif isinstance(region, ast.Lambda):
        stack = [region.body]
    else:
        stack = list(reversed(region.body))
    while stack:
        node = stack.pop()
        if isinstance(node, (*_DEFS, ast.ClassDef)) and node not in traced:
            continue
        yield node
        stack.extend(reversed(list(ast.iter_child_nodes(node))))


class _Reporter:
    def __init__(self, mod: _Module):
        self.mod = mod
        self.findings: list = []
        self._seen: set = set()
        # (line, rule) pairs whose pragma actually suppressed an emit -
        # the stale-suppression pass (DCFM002) reports every pragma NOT
        # in this set once all checkers have run
        self.used_ignores: set = set()

    def emit(self, rule: str, node: ast.AST, message: str) -> None:
        if rule in RULES and RULES[rule].library_only \
                and (self.mod.is_test or self.mod.is_script):
            return
        line = getattr(node, "lineno", 0)
        if rule in self.mod.ignores.get(line, set()):
            self.used_ignores.add((line, rule))
            return
        key = (rule, line, getattr(node, "col_offset", 0))
        if key in self._seen:
            return
        self._seen.add(key)
        self.findings.append(Finding(
            self.mod.path, line, getattr(node, "col_offset", 0), rule,
            message))


# =====================================================================
# DCFM1xx - RNG discipline
# =====================================================================

def _generator_kw(call: ast.Call) -> Optional[ast.AST]:
    """The ``generator=`` argument of a call, None when absent or given
    as a literal None (both draw from the process-global stream)."""
    for k in call.keywords:
        if k.arg == "generator":
            if isinstance(k.value, ast.Constant) and k.value.value is None:
                return None
            return k.value
    return None


def _distribution_names(mod: _Module) -> set:
    """Names bound to a ``torch.distributions`` object anywhere in the
    module (``d = Gamma(a, b)`` after ``from torch.distributions import
    Gamma``): their ``.sample()`` has no generator argument at all."""
    out: set = set()
    for node in ast.walk(mod.tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)
                and mod.resolve(node.value.func).startswith(
                    "torch.distributions.")):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return out


def _variate_call(mod: _Module, call: ast.Call, dists: set) -> str:
    """What this call draws from the global stream ('' if nothing)."""
    full = mod.resolve(call.func)
    if (full.startswith("torch.") and _last(full) in _TORCH_VARIATES
            and full.count(".") == 1):
        return "" if _generator_kw(call) is not None else f"{full}()"
    if not isinstance(call.func, ast.Attribute):
        return ""
    attr = call.func.attr
    if attr in _INPLACE_VARIATES:
        return "" if _generator_kw(call) is not None else f".{attr}()"
    if attr in ("sample", "rsample", "sample_n"):
        recv = call.func.value
        if (isinstance(recv, ast.Name) and recv.id in dists) or (
                isinstance(recv, ast.Call) and mod.resolve(
                    recv.func).startswith("torch.distributions.")):
            return f"torch.distributions .{attr}()"
    return ""


class _SeedFlow:
    """Path-sensitive single-scope seeding tracker (DCFM101's second
    half): one seed expression handed to ``manual_seed`` twice on one
    path gives two identical streams (two generators) or replays one.
    ``if``/``else`` branches count independently (a returning branch
    never merges with the fallthrough); a loop body is walked twice,
    the second time forgetting seeds that mention a name the loop
    rebinds (``manual_seed(base + i)`` differs per iteration, a
    loop-invariant seed does not); rebinding a name forgets the seeds
    that mention it.  Nested defs are separate scopes."""

    def __init__(self, mod: _Module, rep: _Reporter, scope: ast.AST):
        self.mod, self.rep, self.scope = mod, rep, scope

    def run(self) -> None:
        body = self.scope.body if isinstance(self.scope.body, list) else [
            ast.Expr(self.scope.body)]
        self._stmts(body, {})

    def _stmts(self, stmts, seen) -> bool:
        """Process a statement list; True if every path terminates."""
        for st in stmts:
            if isinstance(st, (*_DEFS, ast.ClassDef)):
                continue
            if isinstance(st, (ast.Return, ast.Raise)):
                v = getattr(st, "value", None) or getattr(st, "exc", None)
                if v is not None:
                    self._expr(v, seen)
                return True
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if st.value is not None:
                    self._expr(st.value, seen)
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                self._forget(_bound_names(targets), seen)
            elif isinstance(st, ast.If):
                self._expr(st.test, seen)
                c_body, c_else = dict(seen), dict(seen)
                t_body = self._stmts(st.body, c_body)
                t_else = self._stmts(st.orelse, c_else)
                live = [c for c, t in ((c_body, t_body), (c_else, t_else))
                        if not t]
                if not live:
                    return True
                seen.clear()
                for c in live:
                    seen.update(c)
            elif isinstance(st, (ast.For, ast.While)):
                self._expr(st.iter if isinstance(st, ast.For) else st.test,
                           seen)
                bound = _bound_names([st.target]) if isinstance(
                    st, ast.For) else set()
                for n in ast.walk(st):
                    if isinstance(n, (ast.Assign, ast.AugAssign,
                                      ast.AnnAssign)):
                        bound |= _bound_names(
                            n.targets if isinstance(n, ast.Assign)
                            else [n.target])
                self._forget(bound, seen)
                self._stmts(st.body, seen)
                self._forget(bound, seen)
                self._stmts(st.body, seen)   # the next iteration
                self._stmts(st.orelse, seen)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._expr(item.context_expr, seen)
                if self._stmts(st.body, seen):
                    return True
            elif isinstance(st, ast.Try):
                self._stmts(st.body, seen)
                for h in st.handlers:
                    self._stmts(h.body, dict(seen))
                self._stmts(st.orelse, seen)
                self._stmts(st.finalbody, seen)
            else:
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        self._expr(child, seen)
        return False

    @staticmethod
    def _forget(names: set, seen: dict) -> None:
        for key, mentioned in list(seen.items()):
            if mentioned & names:
                del seen[key]

    def _expr(self, node, seen) -> None:
        for n in ast.walk(node):
            if not (isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _SEED_METHODS and n.args):
                continue
            key = ast.dump(n.args[0])
            if key in seen:
                self.rep.emit(
                    "DCFM101", n,
                    f"seed '{_unparse(n.args[0])}' is handed to "
                    "manual_seed a second time on this path - two "
                    "generators (or one restarted) then draw the SAME "
                    "stream; derive a distinct seed for each stream "
                    "(noise.stream_seed)")
            else:
                seen[key] = {m.id for m in ast.walk(n.args[0])
                             if isinstance(m, ast.Name)}


def _bound_names(targets) -> set:
    out: set = set()
    for t in targets:
        for n in ast.walk(t):
            if isinstance(n, ast.Name):
                out.add(n.id)
    return out


def _unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except (ValueError, TypeError, AttributeError, RecursionError):
        return "<expr>"


def _check_rng(mod: _Module, rep: _Reporter) -> None:
    dists = _distribution_names(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        what = _variate_call(mod, node, dists)
        if what:
            rep.emit("DCFM101", node,
                     f"{what} draws from the process-global stream (no "
                     "generator=) - its values then depend on every other "
                     "draw in the process, and a CUDA graph replays the "
                     "global Philox offset it captured; pass the "
                     "caller's generator (noise.TorchNoise) instead")
    if any("manual_seed" in line for line in mod.lines):
        scopes = [mod.tree] + [n for n in ast.walk(mod.tree)
                               if isinstance(n, _DEFS)]
        for scope in scopes:
            _SeedFlow(mod, rep, scope).run()
    # DCFM102: constant seeds in library code
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _SEED_METHODS and node.args):
            continue
        seed = node.args[0]
        if isinstance(seed, ast.UnaryOp):
            seed = seed.operand
        if isinstance(seed, ast.Constant):
            rep.emit("DCFM102", node,
                     f"{node.func.attr}({_unparse(node.args[0])}) with a "
                     "constant seed in library code - thread the "
                     "caller's seed (FitConfig / noise.stream_seed) "
                     "instead")


# =====================================================================
# DCFM2xx / DCFM3xx - capture hygiene and dtype drift
# =====================================================================

_F64_NAMES = {"torch.float64", "torch.double"}


def _is_float64_dtype(mod: _Module, node: ast.AST) -> bool:
    if _last(mod.resolve(node)) in {"float64", "double"}:
        return True
    return (isinstance(node, ast.Constant)
            and node.value in ("float64", "double", ">f8", "<f8", "f8"))


def _is_torch_f64(mod: _Module, node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and mod.resolve(node) in _F64_NAMES


def _compare_operands(tree: ast.AST) -> set:
    """ids of the operands of comparisons: ``x.dtype == torch.float64``
    is a dtype guard, it computes nothing in double."""
    out: set = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Compare):
            out |= {id(e) for e in [n.left, *n.comparators]}
    return out


def tensor_names(mod: _Module, region: ast.AST) -> set:
    """Names that hold a tensor in a region: parameters annotated
    ``torch.Tensor`` (or Optional of it), and names assigned (anywhere
    in it) from a tensor-valued expression - a fixed point."""
    out: set = set()
    fdef = region
    if not isinstance(fdef, (*_DEFS, ast.Lambda)):
        fdef = mod._owner.get(id(region))
    args = getattr(fdef, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            if a.annotation is not None and any(
                    mod.resolve(n) == "torch.Tensor"
                    or (isinstance(n, ast.Constant)
                        and isinstance(n.value, str)
                        and "Tensor" in n.value)
                    for n in ast.walk(a.annotation)):
                out.add(a.arg)
    body = fdef if isinstance(fdef, (*_DEFS, ast.Lambda)) else region
    assigns = [n for n in ast.walk(body)
               if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign))
               and n.value is not None]
    changed = True
    while changed:
        changed = False
        for node in assigns:
            if not tensor_valued(mod, node.value, out):
                continue
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                elts = t.elts if isinstance(t, (ast.Tuple, ast.List)) \
                    else [t]
                for e in elts:
                    if isinstance(e, ast.Name) and e.id not in out:
                        out.add(e.id)
                        changed = True
    return out


def tensor_valued(mod: _Module, node: ast.AST, names: set) -> bool:
    """Conservative 'this expression is a tensor' (so a Python truth
    test of it reads a device value): a tensor name, a torch call that
    returns a tensor, arithmetic or comparison on one - but not its
    metadata (shape, dtype, device, numel(), ...), which a capture
    fixes, nor a builtin's host value (len, isinstance, int, ...)."""
    if isinstance(node, ast.Name):
        return node.id in names
    if isinstance(node, ast.Attribute):
        if node.attr in _META_ATTRS:
            return False
        return tensor_valued(mod, node.value, names)
    if isinstance(node, ast.Subscript):
        return tensor_valued(mod, node.value, names)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name) and f.id in _HOST_BUILTINS:
            return False
        full = mod.resolve(f)
        if full.startswith("torch."):
            return not (_last(full) in _TORCH_HOST_TAILS
                        or full.startswith(_TORCH_HOST_PREFIXES))
        if isinstance(f, ast.Attribute):
            if f.attr in _META_METHODS:
                return False
            if tensor_valued(mod, f.value, names):
                return True
        return any(tensor_valued(mod, a, names)
                   for a in [*node.args, *(k.value for k in node.keywords)])
    if isinstance(node, ast.Compare):
        if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
               for op in node.ops):
            return False
        return any(tensor_valued(mod, e, names)
                   for e in [node.left, *node.comparators])
    if isinstance(node, ast.BinOp):
        return (tensor_valued(mod, node.left, names)
                or tensor_valued(mod, node.right, names))
    if isinstance(node, ast.UnaryOp):
        return tensor_valued(mod, node.operand, names)
    if isinstance(node, ast.BoolOp):
        return any(tensor_valued(mod, v, names) for v in node.values)
    if isinstance(node, ast.IfExp):
        return (tensor_valued(mod, node.body, names)
                or tensor_valued(mod, node.orelse, names))
    return False


def _check_traced_bodies(mod: _Module, rep: _Reporter) -> None:
    for region in mod.traced:
        names = tensor_names(mod, region)
        guards = _compare_operands(region)
        for node in region_nodes(region, mod.traced):
            if isinstance(node, ast.Call):
                _check_traced_call(mod, rep, node, names)
            elif _is_torch_f64(mod, node) and id(node) not in guards:
                rep.emit("DCFM301", node,
                         f"{mod.resolve(node)} inside a captured function "
                         "(the chain is float32 end to end)")
            resolved = ""
            if isinstance(node, ast.Subscript):
                resolved = mod.resolve(node.value)
            elif isinstance(node, ast.Call):
                resolved = mod.resolve(node.func)
            if resolved in {"os.environ", "os.environ.get", "os.getenv"}:
                rep.emit("DCFM203", node,
                         "os.environ read inside a captured function is "
                         "baked in when the graph is captured and ignored "
                         "on every replay; read it outside and pass the "
                         "value in")
            if isinstance(node, (ast.If, ast.While)):
                test = node.test
                if _is_static_test(test):
                    continue
                if tensor_valued(mod, test, names):
                    rep.emit("DCFM202", node,
                             "Python control flow on a tensor inside a "
                             "captured function: the truth test syncs "
                             "with the card, and the capture bakes in "
                             "the branch it took - every replay runs it; "
                             "use torch.where / a mask")


def _check_traced_call(mod, rep, node, names) -> None:
    full = mod.resolve(node.func)
    f = node.func
    if full in _HOST_SYNC_NP and node.args \
            and tensor_valued(mod, node.args[0], names):
        rep.emit("DCFM201", node,
                 f"{full} of a tensor inside a captured function copies "
                 "it to the host (a sync the capture refuses)")
    elif full in _HOST_SYNC_TORCH or (
            full == "torch.where" and len(node.args) == 1
            and not node.keywords):
        rep.emit("DCFM201", node,
                 f"{full}() inside a captured function waits for the "
                 "card (its result's size or value is read on the host)")
    elif isinstance(f, ast.Attribute) and (
            f.attr in _HOST_SYNC_METHODS or f.attr in {
                "synchronize", "nonzero"}
            or (f.attr == "query" and not node.args)):
        rep.emit("DCFM201", node,
                 f".{f.attr}() inside a captured function waits for the "
                 "card or reads a device value on the host")
    elif isinstance(f, ast.Attribute) and f.attr == "to" and any(
            isinstance(a, ast.Constant) and a.value == "cpu"
            for a in [*node.args, *(k.value for k in node.keywords)]):
        rep.emit("DCFM201", node,
                 ".to('cpu') inside a captured function copies to the "
                 "host")
    elif (isinstance(f, ast.Name) and f.id in {"float", "int", "bool"}
          and node.args and tensor_valued(mod, node.args[0], names)):
        rep.emit("DCFM201", node,
                 f"{f.id}() of a tensor inside a captured function reads "
                 "its value on the host")
    for a in list(node.args) + [k.value for k in node.keywords]:
        if _is_float64_dtype(mod, a):
            rep.emit("DCFM301", a,
                     "float64 dtype inside a captured function (the chain "
                     "is float32 end to end)")
    if isinstance(f, ast.Attribute) and f.attr == "double" \
            and not node.args:
        rep.emit("DCFM301", node,
                 ".double() inside a captured function (the chain is "
                 "float32 end to end)")
    if isinstance(f, ast.Attribute) and f.attr in ("to", "astype", "type") \
            and node.args and isinstance(node.args[0], ast.Name) \
            and node.args[0].id == "float":
        rep.emit("DCFM302", node,
                 f".{f.attr}(float) in captured code (Python's float is "
                 "float64; pin torch.float32)")
    for k in node.keywords:
        if k.arg == "dtype" and isinstance(k.value, ast.Name) \
                and k.value.id == "float":
            rep.emit("DCFM302", k.value,
                     "dtype=float in captured code (Python's float is "
                     "float64; pin torch.float32)")


def _is_static_test(test: ast.AST) -> bool:
    """Tests that are fine in captured code: None/isinstance/shape
    checks - static structure, not captured values."""
    if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in {"isinstance", "hasattr", "len",
                                  "getattr", "callable"}:
            return True
    return False


# tensor methods that take a dtype
_DTYPE_METHODS = {"to", "type", "new_zeros", "new_empty", "new_ones",
                  "new_full", "new_tensor", "view"}


def _check_dtype_module(mod: _Module, rep: _Reporter) -> None:
    """DCFM301/302 outside captured functions: torch.float64 /
    torch.double (not as a dtype guard's operand), ``.double()``, a
    float64 numpy dtype passed to a torch call, and Python's float as a
    torch dtype.  Host-side numpy float64 stays fine
    (utils/diagnostics.py accumulates in double on purpose)."""
    guards = _compare_operands(mod.tree)
    for node in ast.walk(mod.tree):
        if _is_torch_f64(mod, node) and id(node) not in guards:
            rep.emit("DCFM301", node,
                     f"{mod.resolve(node)} - the port's tensors are "
                     "float32 end to end")
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        full = mod.resolve(f)
        if isinstance(f, ast.Attribute) and f.attr == "double" \
                and not node.args:
            rep.emit("DCFM301", node,
                     ".double() casts a tensor to float64 - the port's "
                     "tensors are float32 end to end")
        torch_fn = full.startswith("torch.")
        if torch_fn:
            for a in list(node.args) + [k.value for k in node.keywords]:
                if _is_float64_dtype(mod, a) and not _is_torch_f64(mod, a):
                    rep.emit("DCFM301", a,
                             f"float64 dtype passed to {full} - drifts a "
                             "float32 tensor to double precision")
        if torch_fn or (isinstance(f, ast.Attribute)
                        and f.attr in _DTYPE_METHODS):
            for k in node.keywords:
                if k.arg == "dtype" and isinstance(k.value, ast.Name) \
                        and k.value.id == "float":
                    rep.emit("DCFM302", k.value,
                             f"dtype=float passed to {full or f.attr} "
                             "(Python's float is float64; pin "
                             "torch.float32)")
        if isinstance(f, ast.Attribute) and f.attr == "to" and node.args \
                and isinstance(node.args[0], ast.Name) \
                and node.args[0].id == "float":
            rep.emit("DCFM302", node,
                     ".to(float) casts to float64 (Python's float); pin "
                     "torch.float32")


# =====================================================================
# DCFM4xx - FFI safety
# =====================================================================

def _check_ffi(mod: _Module, rep: _Reporter) -> None:
    tainted = _cdll_tainted(mod)
    declared_arg: set = set()
    declared_res: set = set()
    alias_to_sym: dict = {}
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Assign):
            continue
        # fn = lib.symbol
        if (isinstance(node.value, ast.Attribute)
                and isinstance(node.value.value, ast.Name)
                and node.value.value.id in tainted):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    alias_to_sym[t.id] = node.value.attr
        # fn.argtypes = [...] / lib.sym.restype = ...
        for t in node.targets:
            if isinstance(t, ast.Attribute) and t.attr in ("argtypes",
                                                           "restype"):
                sym = None
                if isinstance(t.value, ast.Name):
                    sym = alias_to_sym.get(t.value.id)
                elif (isinstance(t.value, ast.Attribute)
                      and isinstance(t.value.value, ast.Name)
                      and t.value.value.id in tainted):
                    sym = t.value.attr
                if sym:
                    (declared_arg if t.attr == "argtypes"
                     else declared_res).add(sym)

    def check_sym(node, sym):
        missing = [w for w, s in (("argtypes", declared_arg),
                                  ("restype", declared_res))
                   if sym not in s]
        if missing:
            rep.emit("DCFM401", node,
                     f"foreign function '{sym}' called without "
                     f"{' and '.join(missing)} declared - implicit int "
                     "signatures corrupt 64-bit arguments")

    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in tainted
                and not node.func.attr.startswith("_")):
            check_sym(node, node.func.attr)
        elif (isinstance(node.func, ast.Name)
              and node.func.id in alias_to_sym):
            check_sym(node, alias_to_sym[node.func.id])
    _check_data_as(mod, rep)


def _cdll_tainted(mod: _Module) -> set:
    """Names holding a ctypes.CDLL handle: direct constructions, module
    globals they flow into, and locals assigned from helper functions
    that return a tainted name (fixed point, a few passes)."""
    tainted: set = set()
    returns_tainted: set = set()
    for _ in range(4):
        changed = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assign):
                v, is_t = node.value, False
                if isinstance(v, ast.Call):
                    if _last(mod.resolve(v.func)) in {"CDLL", "LoadLibrary",
                                                      "PyDLL", "WinDLL"}:
                        is_t = True
                    elif (isinstance(v.func, ast.Name)
                          and v.func.id in returns_tainted):
                        is_t = True
                elif isinstance(v, ast.Name) and v.id in tainted:
                    is_t = True
                if is_t:
                    for t in node.targets:
                        if isinstance(t, ast.Name) and t.id not in tainted:
                            tainted.add(t.id)
                            changed = True
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for r in ast.walk(node):
                    if (isinstance(r, ast.Return)
                            and isinstance(r.value, ast.Name)
                            and r.value.id in tainted
                            and node.name not in returns_tainted):
                        returns_tainted.add(node.name)
                        changed = True
        if not changed:
            break
    return tainted


def _check_data_as(mod: _Module, rep: _Reporter) -> None:
    # pointer wrappers: tiny pure-conversion helpers that directly
    # `return param.ctypes.data_as(...)` (native._ptr).  Their CALLERS
    # are checked instead; a function that merely uses data_as on a
    # parameter somewhere is NOT a wrapper and gets checked itself.
    wrappers: set = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = {a.arg for a in node.args.args}
        stmts = [s for s in node.body
                 if not (isinstance(s, ast.Expr)
                         and isinstance(s.value, ast.Constant))]
        if (len(stmts) == 1 and isinstance(stmts[0], ast.Return)
                and _is_data_as(stmts[0].value)
                and isinstance(stmts[0].value.func.value.value, ast.Name)
                and stmts[0].value.func.value.value.id in params):
            wrappers.add(node.name)

    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        guarded = _contiguity_guarded_names(mod, fdef)
        for n in ast.walk(fdef):
            if not isinstance(n, ast.Call):
                continue
            recv = None
            if _is_data_as(n):
                recv = n.func.value.value
            elif (isinstance(n.func, ast.Name) and n.func.id in wrappers
                  and n.args):
                recv = n.args[0]
            if recv is None:
                continue
            if not isinstance(recv, ast.Name):
                rep.emit("DCFM402", n,
                         "pointer taken from a temporary expression - "
                         "the array may be collected while the foreign "
                         "call still uses its memory; bind it to a "
                         "local that outlives the call")
            elif fdef.name not in wrappers and recv.id not in guarded:
                rep.emit("DCFM403", n,
                         f"'{recv.id}' passed by pointer without a "
                         "C-contiguity+dtype guard in this function "
                         "(np.ascontiguousarray it, allocate it here, "
                         "or check .flags.c_contiguous)")


def _is_data_as(n: ast.AST) -> bool:
    return (isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "data_as"
            and isinstance(n.func.value, ast.Attribute)
            and n.func.value.attr == "ctypes")


def _contiguity_guarded_names(mod: _Module, fdef) -> set:
    out: set = set()
    for n in ast.walk(fdef):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            if _last(mod.resolve(n.value.func)) in _CONTIG_PRODUCERS:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
        if (isinstance(n, ast.Attribute) and n.attr == "c_contiguous"
                and isinstance(n.value, ast.Attribute)
                and n.value.attr == "flags"
                and isinstance(n.value.value, ast.Name)):
            out.add(n.value.value.id)
    return out


# =====================================================================
# DCFM5xx - thread-shutdown discipline
# =====================================================================

def _check_threads(mod: _Module, rep: _Reporter) -> None:
    has_join = any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
        and n.func.attr == "join" and not n.args
        for n in ast.walk(mod.tree))
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        if _last(mod.resolve(node.func)) == "Thread":
            for k in node.keywords:
                if (k.arg == "daemon" and isinstance(k.value, ast.Constant)
                        and k.value.value is True):
                    rep.emit("DCFM501", node,
                             "daemon thread in library code: still "
                             "running at interpreter teardown it aborts "
                             "inside native/numpy/JAX (the tier-1 "
                             "SIGABRT class); use a non-daemon thread "
                             "joined before teardown")
            if not has_join:
                rep.emit("DCFM502", node,
                         "thread created in a module with no .join() "
                         "anywhere - nothing bounds its lifetime before "
                         "interpreter teardown")
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr == "start"
                and isinstance(node.func.value, ast.Call)
                and _last(mod.resolve(node.func.value.func)) == "Thread"):
            rep.emit("DCFM502", node,
                     "thread started as a temporary - it can never be "
                     "joined; bind it and join before teardown")


# socketserver-family classes whose instances hold a listening socket and
# (for the Threading mixins) spawn handler threads - the lifecycles the
# DCFM503 shutdown discipline covers.
_SERVER_CLASSES = {
    "ThreadingHTTPServer", "HTTPServer", "ThreadingTCPServer", "TCPServer",
    "ThreadingUDPServer", "UDPServer", "UnixStreamServer",
    "UnixDatagramServer", "ForkingTCPServer", "ForkingUDPServer",
}


def _check_servers(mod: _Module, rep: _Reporter) -> None:
    """DCFM503: server lifecycles without shutdown()/server_close() on the
    exit path.  Module-granular like DCFM502: a ``serve_forever()`` needs
    a ``.shutdown()`` somewhere (it is the only thing that stops the
    accept loop), and a constructed server needs a ``.server_close()``
    (or a with-statement, whose __exit__ closes the socket)."""
    has_shutdown = has_close = False
    with_ctx: set = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            if n.func.attr == "shutdown":
                has_shutdown = True
            elif n.func.attr == "server_close":
                has_close = True
        if isinstance(n, ast.With):
            for item in n.items:
                if isinstance(item.context_expr, ast.Call):
                    with_ctx.add(id(item.context_expr))
    for n in ast.walk(mod.tree):
        if not isinstance(n, ast.Call):
            continue
        if (isinstance(n.func, ast.Attribute)
                and n.func.attr == "serve_forever" and not has_shutdown):
            rep.emit("DCFM503", n,
                     "serve_forever() in a module with no .shutdown() "
                     "call - nothing can ever stop the accept loop; put "
                     "shutdown() on the exit path (from another thread)")
        base = _last(mod.resolve(n.func))
        if (base in _SERVER_CLASSES and id(n) not in with_ctx
                and not has_close):
            rep.emit("DCFM503", n,
                     f"{base} constructed in a module with no "
                     ".server_close() call and outside a with-statement - "
                     "the listening socket (and any handler threads) "
                     "outlive interpreter teardown; close it on the exit "
                     "path")


# =====================================================================
# DCFM6xx - robustness discipline
# =====================================================================

# A call to any of these names inside an except body counts as "the
# failure was surfaced" (warnings.warn, logging methods, print-style
# reporting).  Deliberately generous: the rule hunts SILENT swallows.
_LOG_CALL_NAMES = {"warn", "warning", "error", "exception", "log", "debug",
                   "info", "critical", "print", "write"}

_VERIFY_CALL_NAMES = {"_verify_crc", "verify_checkpoint", "verify_crc",
                      "verify_panel", "panel_crc32"}


def _is_broad_handler(mod: _Module, handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    elts = t.elts if isinstance(t, ast.Tuple) else [t]
    return any(_last(mod.resolve(e)) in ("Exception", "BaseException")
               for e in elts)


def _is_leaf_subscript(node: ast.AST) -> bool:
    """z["leaf_3"] / z[f"leaf_{i}"] - a raw checkpoint payload read."""
    if not isinstance(node, ast.Subscript):
        return False
    sl = node.slice
    if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
        return sl.value.startswith("leaf_")
    if isinstance(sl, ast.JoinedStr) and sl.values:
        head = sl.values[0]
        return (isinstance(head, ast.Constant)
                and isinstance(head.value, str)
                and head.value.startswith("leaf_"))
    return False


def _check_robustness(mod: _Module, rep: _Reporter) -> None:
    # DCFM601: swallowed failures.  A broad handler is fine when its body
    # re-raises, calls a logging/warning function, or USES the bound
    # exception (building a failure message is handling) - anything else
    # makes the error vanish.
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad_handler(mod, node):
            continue
        body = [m for s in node.body for m in ast.walk(s)]
        if any(isinstance(m, ast.Raise) for m in body):
            continue
        if node.name and any(isinstance(m, ast.Name) and m.id == node.name
                             for m in body):
            continue
        if any(isinstance(m, ast.Call)
               and _last(_dotted(m.func)).lower() in _LOG_CALL_NAMES
               for m in body):
            continue
        rep.emit("DCFM601", node,
                 "broad except swallows the failure (no re-raise, no "
                 "log/warn, bound exception unused) - surface it, or "
                 "annotate the swallow: `# dcfm: ignore[DCFM601] - <why>`")

    # DCFM602: unverified checkpoint payload reads.  Function-granular
    # like the FFI contiguity rule: np.load plus a raw 'leaf_*' subscript
    # with no integrity-verification call in the same function.
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        sub = [m for s in fn.body for m in ast.walk(s)]
        loads = [m for m in sub if isinstance(m, ast.Call)
                 and mod.resolve(m.func) == "numpy.load"]
        if not loads:
            continue
        leaf_reads = [m for m in sub if _is_leaf_subscript(m)]
        if not leaf_reads:
            continue
        if any(isinstance(m, ast.Call)
               and _last(_dotted(m.func)) in _VERIFY_CALL_NAMES
               for m in sub):
            continue
        rep.emit("DCFM602", leaf_reads[0],
                 "raw checkpoint leaf read with no integrity check in "
                 "this function - route the payload through "
                 "utils.checkpoint._verify_crc / verify_checkpoint "
                 "before resuming on bytes from disk")


# =====================================================================
# DCFM7xx - multi-process discipline
# =====================================================================

# torch.distributed calls every rank of the group must issue (point-to-
# point send/recv are rank-conditional by design and not listed)
_DIST_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "broadcast", "broadcast_object_list", "reduce",
    "reduce_scatter", "reduce_scatter_tensor", "gather", "gather_object",
    "scatter", "scatter_object_list", "barrier", "monitored_barrier",
    "all_to_all", "all_to_all_single", "new_group", "new_subgroups",
}
# parallel/shard.RankMesh's methods that issue collectives
_MESH_COLLECTIVES = {
    "reduce_fn", "gather_fn", "reduce_stats", "total", "gather_ints",
    "share", "decide", "gather_counts", "gather_traces", "gather_carries",
    "link_panels", "fetch",
}
_RANK_NAME_RE = re.compile(
    r"^(rank|process_id|process_index|(local|global|my|this|node)_rank)$")
_RANK_CALLS = {"get_rank", "process_index", "get_node_local_rank"}


def _is_rank_test(mod: _Module, test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and _RANK_NAME_RE.match(n.id):
            return True
        if isinstance(n, ast.Attribute) and _RANK_NAME_RE.match(n.attr):
            return True
        if isinstance(n, ast.Call) and _last(
                mod.resolve(n.func)) in _RANK_CALLS:
            return True
    return False


def _collective_calls(mod: _Module, stmts) -> list:
    """(name, call) of every collective issued in ``stmts`` (nested
    defs excluded: they run when called, not here)."""
    out = []
    stack = list(stmts)
    while stack:
        node = stack.pop()
        if isinstance(node, (*_DEFS, ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Call):
            full = mod.resolve(node.func)
            if (full.startswith("torch.distributed.")
                    and _last(full) in _DIST_COLLECTIVES):
                out.append((_last(full), node))
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr in _MESH_COLLECTIVES
                  and "mesh" in _last(_dotted(node.func.value)).lower()):
                out.append((node.func.attr, node))
        stack.extend(ast.iter_child_nodes(node))
    return out


def _terminates(stmts) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _check_multihost(mod: _Module, rep: _Reporter) -> None:
    """DCFM701: a collective issued on one side of a branch on the rank
    that the other side never issues - the ranks that take the other
    side never join it, and the group deadlocks.  An ``if`` on the rank
    (``rank``/``process_id`` names, ``dist.get_rank()``) is compared
    branch against branch by collective name; an ``if`` whose body
    returns (or raises) with no ``else`` is compared against the rest of
    its block, which only the other ranks run.  Both sides issuing the
    same collective (rank 0 gathers into a list, the others send None)
    is the sanctioned shape."""

    def flag(name, call, side):
        rep.emit("DCFM701", call,
                 f"collective {name}() issued only by the ranks that "
                 f"take {side} of a branch on the rank - the other ranks "
                 "never issue it and the group deadlocks; issue it on "
                 "every rank (pass None / an empty buffer where a rank "
                 "has nothing to give)")

    def compare(a, b, side_a, side_b):
        names_a = {n for n, _ in a}
        names_b = {n for n, _ in b}
        for n, call in a:
            if n not in names_b:
                flag(n, call, side_a)
        for n, call in b:
            if n not in names_a:
                flag(n, call, side_b)

    def block(stmts):
        for i, st in enumerate(stmts):
            if isinstance(st, (*_DEFS, ast.ClassDef)):
                continue
            if isinstance(st, ast.If) and _is_rank_test(mod, st.test):
                body = _collective_calls(mod, st.body)
                if _terminates(st.body) and not st.orelse:
                    rest = _collective_calls(mod, stmts[i + 1:])
                    compare(body, rest, "one side", "the fall-through")
                else:
                    compare(body, _collective_calls(mod, st.orelse),
                            "the if side", "the else side")
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if isinstance(sub, list) and sub and isinstance(
                        sub[0], ast.stmt):
                    block(sub)
            for h in getattr(st, "handlers", ()):
                block(h.body)

    block(mod.tree.body)
    for fdef in ast.walk(mod.tree):
        if isinstance(fdef, _DEFS):
            block(fdef.body)


# =====================================================================
# DCFM8xx - runtime pipeline discipline
# =====================================================================

def _async_marker(mod: _Module, node: ast.AST) -> bool:
    """An asynchronous device-to-host dispatch, an event recorded behind
    one, or a wait on such an event (the drain half): a call with
    ``non_blocking=True``, ``ev.record(stream)`` (one non-string
    positional argument at most - the flight recorder's
    ``record("kind", ...)`` is telemetry), ``stream.record_event()``, or
    ``ev.synchronize()`` - an event's or stream's, not the device-wide
    ``torch.cuda.synchronize()``."""
    if not isinstance(node, ast.Call):
        return False
    if any(k.arg == "non_blocking" and isinstance(k.value, ast.Constant)
           and k.value.value is True for k in node.keywords):
        return True
    f = node.func
    if not isinstance(f, ast.Attribute):
        return False
    if f.attr == "record_event" or (
            f.attr == "synchronize"
            and not mod.resolve(f).startswith("torch.")):
        return True
    return (f.attr == "record" and not node.keywords
            and len(node.args) <= 1
            and not (node.args and isinstance(node.args[0], ast.Constant)))


def _blocking_fetch(mod: _Module, node: ast.Call) -> str:
    full = mod.resolve(node.func)
    if full == "torch.cuda.synchronize":
        return "torch.cuda.synchronize()"
    if full in {"numpy.asarray", "numpy.array"} and node.args \
            and isinstance(node.args[0], ast.Name):
        return f"{_last(full)} on '{node.args[0].id}'"
    if isinstance(node.func, ast.Attribute) and node.func.attr in {
            "cpu", "item", "tolist", "numpy"} and not node.args:
        return f".{node.func.attr}()"
    return ""


def _check_pipeline(mod: _Module, rep: _Reporter) -> None:
    """DCFM801: blocking host fetch in a runtime pipeline module with no
    preceding asynchronous copy or event record in the same function.

    Scope is the runtime package only (``mod.is_runtime`` - path-gated,
    so serve/api code is untouched), function-granular and nested-def-
    exclusive, and PRECEDENCE-aware: a fetch on a line at or after the
    function's first ``non_blocking=True`` copy (or event record, or
    wait on an event) is the drain half of an async pair; one before
    any dispatch is the serializing sync fetch the rule hunts.  ``np.asarray`` / ``np.array``
    count on a bare name only, so list-literal payloads stay quiet."""
    if not mod.is_runtime:
        return
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, _DEFS):
            continue
        skip: set = set()
        for nd in ast.walk(fdef):
            if nd is not fdef and isinstance(nd, _DEFS):
                for sub in ast.walk(nd):
                    skip.add(id(sub))
        own = [n for n in ast.walk(fdef) if id(n) not in skip]
        first_async = min((n.lineno for n in own
                           if _async_marker(mod, n)),
                          default=None)
        for n in own:
            if not isinstance(n, ast.Call):
                continue
            if first_async is not None and n.lineno >= first_async:
                continue
            what = _blocking_fetch(mod, n)
            if what:
                rep.emit("DCFM801", n,
                         f"{what} in a runtime pipeline function with no "
                         "preceding non_blocking copy or event record - a "
                         "blocking fetch here serializes the chain behind "
                         "the device->host link; dispatch the async copy "
                         "at the chunk boundary and drain off-thread "
                         "(runtime/pipeline.StreamingFetcher), or annotate "
                         "the deliberate sync fetch")


# =====================================================================
# DCFM9xx - telemetry discipline
# =====================================================================

# modules whose JOB is console output: the CLI surfaces (argparse
# protocols, stdout/stderr JSON lines) - everything else in the library
# routes telemetry through dcfm_tpu.obs
_OBS_EXEMPT_BASENAMES = {"cli.py", "__main__.py"}


def _check_obs(mod: _Module, rep: _Reporter) -> None:
    """DCFM901: bare ``print`` / ``sys.std{out,err}.write`` in library
    modules.  "Bare" means console-bound: a ``print`` with no ``file=``
    keyword, or one whose ``file=`` resolves to ``sys.stdout`` /
    ``sys.stderr``.  ``print(..., file=<some handle variable>)`` is
    parameterized output (the isolate runner's ``out`` parameter) and
    stays quiet - the rule hunts telemetry that bypasses the flight
    recorder, not functions that write where their caller pointed."""
    if os.path.basename(mod.path) in _OBS_EXEMPT_BASENAMES:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        full = mod.resolve(node.func)
        if full in {"sys.stdout.write", "sys.stderr.write"}:
            rep.emit("DCFM901", node,
                     f"{full}() in a library module - console output is "
                     "invisible to the flight recorder; emit through "
                     "dcfm_tpu.obs (recorder.record), or annotate a "
                     "deliberate protocol line")
            continue
        if not (isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            continue
        file_kw = next((k for k in node.keywords if k.arg == "file"),
                       None)
        if file_kw is not None and mod.resolve(file_kw.value) not in {
                "sys.stdout", "sys.stderr"}:
            continue    # parameterized handle: caller decides the sink
        rep.emit("DCFM901", node,
                 "bare print() in a library module - console output is "
                 "invisible to the flight recorder and unscrapable by "
                 "metrics; emit through dcfm_tpu.obs (recorder.record / "
                 "a registry metric), or annotate a deliberate CLI "
                 "protocol line")


# =====================================================================
# DCFM10xx - serving discipline
# =====================================================================

# handler base classes whose route methods run one-per-request on a
# handler thread - the threads a single slow client can park forever
_HANDLER_CLASSES = {
    "BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
    "CGIHTTPRequestHandler", "StreamRequestHandler",
    "DatagramRequestHandler", "BaseRequestHandler",
}

_ROUTE_METHOD_RE = re.compile(r"^(do_[A-Z]\w*|handle|handle_one_request)$")

# socket methods that block until the PEER acts - unbounded on a socket
# with no timeout
_SOCKET_BLOCKING_OPS = {"recv", "recv_into", "recvfrom", "accept",
                        "connect"}


def _check_handlers(mod: _Module, rep: _Reporter) -> None:
    """DCFM1001: unbounded blocking wait inside a request-handler route
    method.  A route method (``do_GET``/``handle``/... of a
    ``BaseHTTPRequestHandler``/``StreamRequestHandler`` subclass) runs
    on a per-request handler thread; a ``.join()`` or queue ``.get()``
    with no timeout, or a blocking op on a socket the method itself
    created and never ``settimeout``-ed, lets one slow peer park that
    thread forever - the slow-loris hang class.  Every wait in a
    request path must carry a deadline."""
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if not any(_last(mod.resolve(b)) in _HANDLER_CLASSES
                   for b in cls.bases):
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if not _ROUTE_METHOD_RE.match(meth.name):
                continue
            # sockets this method creates, and which of them it bounds
            made_sockets: set = set()
            timed_sockets: set = set()
            for n in ast.walk(meth):
                if (isinstance(n, ast.Assign)
                        and isinstance(n.value, ast.Call)
                        and mod.resolve(n.value.func) in {
                            "socket.socket", "socket.create_connection"}):
                    has_timeout = any(k.arg == "timeout"
                                      for k in n.value.keywords)
                    for tgt in n.targets:
                        if isinstance(tgt, ast.Name):
                            (timed_sockets if has_timeout
                             else made_sockets).add(tgt.id)
                if (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr == "settimeout"
                        and isinstance(n.func.value, ast.Name)):
                    timed_sockets.add(n.func.value.id)
            for n in ast.walk(meth):
                if not (isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)):
                    continue
                attr = n.func.attr
                has_timeout_kw = any(k.arg == "timeout"
                                     for k in n.keywords)
                if (attr == "join" and not n.args and not n.keywords):
                    rep.emit("DCFM1001", n,
                             f"timeout-less .join() inside handler route "
                             f"{cls.name}.{meth.name} - one wedged "
                             "thread parks this handler thread forever; "
                             "join(timeout=...) and handle the miss")
                elif (attr == "get" and not n.args
                        and not has_timeout_kw):
                    rep.emit("DCFM1001", n,
                             f"timeout-less blocking .get() inside "
                             f"handler route {cls.name}.{meth.name} - an "
                             "empty queue parks this handler thread "
                             "forever; get(timeout=...) and map the "
                             "Empty to a typed 503/504")
                elif (attr in _SOCKET_BLOCKING_OPS
                        and isinstance(n.func.value, ast.Name)
                        and n.func.value.id in made_sockets
                        and n.func.value.id not in timed_sockets):
                    rep.emit("DCFM1001", n,
                             f".{attr}() on a timeout-less socket inside "
                             f"handler route {cls.name}.{meth.name} - a "
                             "silent peer blocks forever; settimeout() "
                             "the socket the method created")


# =====================================================================
# DCFM1301 - daemon poll-loop shutdown discipline
# =====================================================================

def _check_poll_loops(mod: _Module, rep: _Reporter) -> None:
    """DCFM1301: a constant-condition polling loop (``while True:`` /
    ``while 1:``) that paces itself with ``time.sleep`` but consults no
    shutdown signal - no ``break``, no ``return``, and no
    ``.wait()``/``.is_set()`` event call anywhere in its body.  Such a
    daemon loop can only be stopped by killing its thread or process:
    SIGTERM drains nothing, tests leak the thread, and at interpreter
    teardown it is the DCFM501 SIGABRT class wearing a sleep.  Pace the
    loop with ``threading.Event.wait(interval)`` and gate each turn on
    ``.is_set()`` (the watch daemon's idiom), or give it an exit
    path."""
    for loop in ast.walk(mod.tree):
        if not isinstance(loop, ast.While):
            continue
        if not (isinstance(loop.test, ast.Constant) and loop.test.value):
            continue
        sleeps = False
        has_exit = bool(loop.orelse)   # while/else implies a break path
        for n in ast.walk(loop):
            if isinstance(n, (ast.Break, ast.Return)):
                has_exit = True
            elif isinstance(n, ast.Call):
                if mod.resolve(n.func) == "time.sleep":
                    sleeps = True
                elif (isinstance(n.func, ast.Attribute)
                        and n.func.attr in ("wait", "is_set")):
                    # an Event consulted or used as the pacer IS the
                    # shutdown seam this rule wants
                    has_exit = True
        if sleeps and not has_exit:
            rep.emit("DCFM1301", loop,
                     "constant-true poll loop paces with time.sleep() "
                     "but consults no shutdown signal (no break/return, "
                     "no Event .wait()/.is_set()) - it can only be "
                     "stopped by killing the thread; pace with "
                     "stop.wait(interval) and check stop.is_set()")


# =====================================================================
# DCFM1401 - chain-axis reduction discipline
# =====================================================================

def _chain_name(node: ast.AST) -> bool:
    """A Name (or simple attribute access on one) whose identifier
    declares chain-major provenance."""
    if isinstance(node, ast.Name):
        return "chain" in node.id.lower()
    if isinstance(node, ast.Attribute):
        return "chain" in node.attr.lower()
    return False


def _bare_axis0(call: ast.Call, method: bool) -> bool:
    """True when the reduction collapses the leading axis implicitly:
    no axis argument at all, or a bare literal 0 - numpy's ``axis=``,
    torch's ``dim=``, or the positional axis (the first argument of a
    method, the second of ``np.mean(x, 0)`` / ``torch.sum(x, 0)``).  An
    axis spelled any other way (a named constant, a non-zero index, a
    tuple) counts as the author naming the axis deliberately."""
    for kw in call.keywords:
        if kw.arg in ("axis", "dim"):
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value == 0)
    pos = 0 if method else 1
    if len(call.args) > pos:
        a = call.args[pos]
        return isinstance(a, ast.Constant) and a.value == 0
    return True


_REDUCE_FNS = {f"{m}.{r}" for m in ("numpy", "torch")
               for r in ("mean", "sum")}


def _check_chain_reductions(mod: _Module, rep: _Reporter) -> None:
    """DCFM1401: a host reduction over a chain-major array without the
    chain axis named.  Trace blocks, pooled Sigma, and draws are ALWAYS
    chain-major (single-chain runs carry a length-1 leading axis), so a
    bare ``.mean(axis=0)`` / ``.mean(0)`` on a name containing 'chain'
    conflates 'average over chains' with 'average over draws'.
    Functions whose own name contains 'chain' (pool_chains,
    _pool_chain_axis) ARE the sanctioned seam and are skipped."""

    def visit(node: ast.AST, in_chain_fn: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _DEFS):
                visit(child, in_chain_fn
                      or "chain" in child.name.lower())
                continue
            if isinstance(child, ast.Call) and not in_chain_fn:
                target, method = None, False
                fn = mod.resolve(child.func)
                if fn in _REDUCE_FNS and child.args:
                    target = child.args[0]
                elif (isinstance(child.func, ast.Attribute)
                        and child.func.attr in ("mean", "sum")):
                    target, method = child.func.value, True
                if (target is not None and _chain_name(target)
                        and _bare_axis0(child, method)):
                    rep.emit(
                        "DCFM1401", child,
                        "host reduction over a chain-major array "
                        "collapses the leading chain axis implicitly "
                        "(bare axis/dim 0, or none) - pool through "
                        "pool_chains()/_pool_chain_axis() or name the "
                        "chain axis in the reducing helper")
            visit(child, in_chain_fn)

    visit(mod.tree, False)


# =====================================================================
# DCFM1501 - dense-quadratic materialization
# =====================================================================

_ALLOC_FNS = frozenset(
    f"{m}.{a}" for m in ("numpy", "torch")
    for a in ("zeros", "empty", "ones", "full"))
_NEW_ALLOC_METHODS = {"new_zeros", "new_empty", "new_ones", "new_full"}


def _alloc_dims(mod: _Module, node: ast.Call) -> Optional[list]:
    """The shape of an allocation call as a list of dim expressions, or
    None: a tuple/list first argument (or ``size=``), or - torch's
    varargs form - every positional argument (``torch.zeros(p, p)``,
    ``x.new_zeros(p, p)``)."""
    full = mod.resolve(node.func)
    method = (isinstance(node.func, ast.Attribute)
              and node.func.attr in _NEW_ALLOC_METHODS)
    if full not in _ALLOC_FNS and not method:
        return None
    size = next((k.value for k in node.keywords
                 if k.arg in ("size", "shape")), None)
    if size is None and node.args:
        size = node.args[0]
    if isinstance(size, (ast.Tuple, ast.List)):
        return size.elts
    varargs = method and node.func.attr != "new_full"
    if (full.startswith("torch.") and not full.endswith(".full")) \
            or varargs:
        return [a for a in node.args if not isinstance(a, ast.Starred)]
    return None


def _check_dense_quadratic(mod: _Module, rep: _Reporter) -> None:
    """DCFM1501: an allocation whose shape repeats a symbolic dimension
    - the (p, p) / (pairs, P, P) dense-buffer signature - in numpy
    (np.zeros/empty/ones/full, the host assembly) or torch
    (torch.zeros/empty/ones/full and ``.new_zeros/new_empty/...``, the
    device).  At the scale-out shapes the streaming ingest targets
    (p >= 1e6) such a buffer is hundreds of GB, so library code routes
    through the packed-panel seams; the handful of sanctioned assembly
    sites (force=True restores, the native assembler's output, device-
    side packed accumulators) carry inline pragmas.  Constant dims are
    ignored: torch.zeros((3, 3)) repeats no *symbol*."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        elts = _alloc_dims(mod, node)
        if not elts or len(elts) < 2:
            continue
        seen: set = set()
        repeated = None
        for e in elts:
            if isinstance(e, ast.Constant):
                continue
            dump = ast.dump(e)
            if dump in seen:
                repeated = e
                break
            seen.add(dump)
        if repeated is None:
            continue
        # numpy sites are the JAX linter's too, so they take its pragma
        form = ("dcfm" if mod.resolve(node.func).startswith("numpy.")
                else "dcfm-torch")
        rep.emit(
            "DCFM1501", node,
            f"shape repeats the symbolic dimension "
            f"'{_unparse(repeated)}' - a dense O(d^2) buffer that is "
            "hundreds of GB at the scale-out shapes (p >= 1e6) the "
            "streaming ingest supports.  Route through the packed-panel "
            "/ sigma_block / artifact seams, or annotate a sanctioned "
            f"assembly site with `# {form}: ignore[DCFM1501] - <why>`")


# =====================================================================
# DCFM16xx - mixed-precision discipline
# =====================================================================

_LOWP_DTYPES = {"torch.bfloat16", "torch.float16", "torch.half"}
_LOWP_STRS = {"bfloat16", "float16", "bf16", "fp16", "half"}
_LOWP_METHODS = {"bfloat16", "half"}
_MATMUL_FNS = {"torch.mm", "torch.bmm", "torch.matmul", "torch.einsum",
               "torch.baddbmm", "torch.addmm", "torch.addbmm",
               "torch.tensordot", "torch.linalg.matmul",
               "torch.linalg.multi_dot", "torch.chain_matmul",
               "torch.nn.functional.linear"}
_MATMUL_METHODS = {"mm", "bmm", "matmul"}


def _is_lowp_dtype_expr(mod: _Module, node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _LOWP_STRS
    return mod.resolve(node) in _LOWP_DTYPES


def _is_lowp_cast(mod: _Module, node) -> bool:
    """``x.to(torch.bfloat16)`` / ``x.bfloat16()`` / ``x.half()`` /
    ``torch.zeros(..., dtype=torch.float16)`` - an expression whose
    OUTERMOST operation produces a low-precision tensor (so
    ``x.to(torch.bfloat16).float()``, the float32 upcast of the rounded
    values, is not one)."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _LOWP_METHODS and not node.args:
            return True
        if f.attr in ("to", "type") and any(
                _is_lowp_dtype_expr(mod, a)
                for a in [*node.args, *(k.value for k in node.keywords
                                         if k.arg == "dtype")]):
            return True
    if mod.resolve(f).startswith("torch."):
        for k in node.keywords:
            if k.arg == "dtype" and _is_lowp_dtype_expr(mod, k.value):
                return True
    return False


def _check_precision_matmul(mod: _Module, rep: _Reporter) -> None:
    """DCFM1601: a contraction over bf16/f16-cast operands without
    ``out_dtype=torch.float32`` returns (and rounds) its result in the
    LOW precision - the one way the mixed-precision sweep
    (BackendConfig.compute_dtype="bf16") can silently void its accuracy
    contract, since every other piece (state, RNG, K x K factorizations)
    stays f32 by construction.  models/conditionals.mm_bf16 is the
    sanctioned seam: ``torch.mm/bmm(..., out_dtype=torch.float32)`` on
    the card, the float32 upcast of the rounded inputs elsewhere.

    Taint is name-based per module: names assigned from a low-precision
    cast anywhere in the file, plus inline cast expressions used
    directly as operands.  Scope-blind on purpose - a name that holds
    bf16 in ANY scope deserves the annotation everywhere it is
    contracted; shadowing false positives carry an inline pragma."""
    tainted: set = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign):
            value = node.value
            pairs = ([(t, value) for t in node.targets]
                     if not (isinstance(value, ast.Tuple) and all(
                         isinstance(t, ast.Tuple)
                         and len(t.elts) == len(value.elts)
                         for t in node.targets))
                     else [(te, ve) for t in node.targets
                           for te, ve in zip(t.elts, value.elts)])
            for t, v in pairs:
                if isinstance(t, ast.Name) and _is_lowp_cast(mod, v):
                    tainted.add(t.id)
        elif (isinstance(node, ast.AnnAssign) and node.value is not None
              and _is_lowp_cast(mod, node.value)
              and isinstance(node.target, ast.Name)):
            tainted.add(node.target.id)

    def lowp_operand(a) -> bool:
        return ((isinstance(a, ast.Name) and a.id in tainted)
                or _is_lowp_cast(mod, a))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
            if lowp_operand(node.left) or lowp_operand(node.right):
                rep.emit(
                    "DCFM1601", node,
                    "`@` on a bfloat16/float16 operand returns and rounds "
                    "its result in the low precision - use "
                    "torch.mm/bmm(..., out_dtype=torch.float32) (the "
                    "models/conditionals.mm_bf16 pattern)")
        elif isinstance(node, ast.Call):
            full = mod.resolve(node.func)
            operands = list(node.args)
            if full not in _MATMUL_FNS:
                if not (isinstance(node.func, ast.Attribute)
                        and node.func.attr in _MATMUL_METHODS
                        and not full.startswith(("numpy.", "torch."))):
                    continue
                operands.append(node.func.value)
            if any(k.arg == "out_dtype" for k in node.keywords):
                continue
            if any(lowp_operand(a) for a in operands):
                name = full if full in _MATMUL_FNS else \
                    f".{node.func.attr}()"
                rep.emit(
                    "DCFM1601", node,
                    f"{name} on a bfloat16/float16 operand without "
                    "out_dtype=torch.float32 - the product is returned "
                    "(and rounded) in the low input precision; route "
                    "it through models/conditionals.mm_bf16 so only the "
                    "MULTIPLY runs low-precision (README 'Precision "
                    "policy')")


# =====================================================================
# DCFM17xx - process-group conformance
# =====================================================================

_GROUP_CTORS = {"torch.distributed.new_group",
                "torch.distributed.new_subgroups",
                "torch.distributed.init_process_group",
                "torch.distributed.init_device_mesh",
                "torch.distributed.device_mesh.init_device_mesh"}


def _check_partition_specs(mod: _Module, rep: _Reporter) -> None:
    """DCFM1701: a process group or a mesh layout built outside
    parallel/ - the rank layout (parallel/mesh.RankLayout and its
    make_layout / make_pod_layout), the groups (parallel/shard.RankMesh)
    and the rendezvous (parallel/multihost.initialize,
    parallel/shard._init_group) live in ONE package, so a placement
    change edits one place and the trace gate's group checks
    (DCFM1801/1802/1808) audit every group.  parallel/ itself - their
    home - is exempt."""
    if mod.is_parallel:
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        full = mod.resolve(node.func)
        if full not in _GROUP_CTORS and _last(full) != "RankLayout":
            continue
        rep.emit(
            "DCFM1701", node,
            f"{_last(full)}(...) outside parallel/ - the rank layout, "
            "the process groups and the rendezvous live in ONE package "
            "(parallel/mesh.make_layout / make_pod_layout, "
            "parallel/shard.RankMesh, parallel/multihost.initialize) so "
            "a placement change edits one place and the trace gate "
            "audits every group.  Route through a parallel/ helper, or "
            "annotate a sanctioned one-off with "
            "`# dcfm-torch: ignore[DCFM1701] - <why>`")


# =====================================================================
# DCFM1901 - promotion-pointer discipline
# =====================================================================

_POINTER_MUTATORS = {"os.replace", "os.rename", "os.link"}
_POINTER_CONST = "dcfm_tpu.serve.promote.POINTER_FILE"


def _names_pointer(mod: _Module, node: ast.AST) -> bool:
    """True when any subexpression of ``node`` names the promotion
    pointer: the literal ``"CURRENT"`` (or a ``"CURRENT."``-prefixed
    tmp/audit sibling) or a name resolving to
    ``serve.promote.POINTER_FILE`` through the import aliases."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            if sub.value == "CURRENT" or sub.value.startswith("CURRENT."):
                return True
        elif isinstance(sub, (ast.Name, ast.Attribute)):
            full = mod.resolve(sub)
            if full == _POINTER_CONST or full == "POINTER_FILE":
                return True
    return False


def _check_pointer_mutation(mod: _Module, rep: _Reporter) -> None:
    """DCFM1901: os.replace/os.rename/os.link targeting a ``CURRENT``
    promotion pointer outside serve/promote.py.  The pointer
    compare-and-swap (verify, monotonic generation, atomic replace,
    audit hardlink, promotion event) lives in exactly one function; a
    second writer can re-number history or flip the fleet to an
    unverified artifact without a recorded promotion.  serve/promote.py
    itself - the CAS's home - is exempt."""
    parts = str(mod.path).replace("\\", "/").split("/")
    if parts[-1] == "promote.py" and len(parts) >= 2 \
            and parts[-2] == "serve":
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        full = mod.resolve(node.func)
        if full not in _POINTER_MUTATORS:
            continue
        if not any(_names_pointer(mod, a) for a in node.args) and \
                not any(_names_pointer(mod, k.value)
                        for k in node.keywords):
            continue
        fn = full.rsplit(".", 1)[-1]
        rep.emit(
            "DCFM1901", node,
            f"os.{fn}(...) targets a CURRENT promotion pointer outside "
            "serve/promote.py - the pointer compare-and-swap (verify, "
            "monotonic generation, atomic replace, audit hardlink, "
            "promotion event) lives in exactly one place.  Route the "
            "move through promote_artifact / promote_delta, or "
            "annotate a sanctioned exception with "
            "`# dcfm: ignore[DCFM1901] - <why>`")


# =====================================================================
# DCFM2001 - elastic-resume topology discipline
# =====================================================================

_TOPOLOGY_CALLS = {"torch.cuda.device_count",
                   "torch.distributed.get_world_size"}
# Function-name hints that put a def on the resume/checkpoint carry
# path.  Deliberately function-scoped, not module-scoped: mesh sizing
# and launch-time capacity probes legitimately read live topology, and
# the hazard is specifically arithmetic that must survive a restart on
# DIFFERENT capacity (elastic resume, README "Elastic execution").
_RESUME_HINTS = ("resume", "checkpoint", "rewind", "restore",
                 "carryover", "elastic", "window", "warm")


def _topology_site(mod: _Module, node: ast.AST) -> str:
    """The live topology query when ``node`` is one - a direct
    ``torch.cuda.device_count()`` / ``dist.get_world_size()`` call, or
    ``len(...ranks)`` of a rank list - else ''."""
    if not isinstance(node, ast.Call):
        return ""
    full = mod.resolve(node.func)
    if full in _TOPOLOGY_CALLS:
        return f"{full}()"
    if (isinstance(node.func, ast.Name) and node.func.id == "len"
            and node.args):
        arg = node.args[0]
        if isinstance(arg, ast.Call):
            arg = arg.func
        if "ranks" in _last(_dotted(arg)).lower():
            return f"len({_unparse(node.args[0])})"
    return ""


def _check_topology_constants(mod: _Module, rep: _Reporter) -> None:
    """DCFM2001: live topology queries feeding carry-shape or
    window-divisor arithmetic inside resume/checkpoint-path functions.
    Elastic resume restarts a checkpoint on a DIFFERENT capacity than
    the one that saved it: a shape or divisor derived from
    torch.cuda.device_count()/dist.get_world_size()/len(ranks) silently
    mis-sizes carries or mis-divides the pooled accumulators once the
    topology changes.  Bookkeeping must flow from the checkpoint's
    recorded meta (``topology``, ``chain_acc_starts``, ``fold_draws``).
    Quiet by construction: recording live capacity INTO meta (a dict
    literal), equality gates (ast.Compare), and per-process file
    naming (plain call arguments) - only arithmetic (ast.BinOp) and
    subscript bounds are carry/divisor flow."""
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        low = fdef.name.lower()
        if not any(h in low for h in _RESUME_HINTS):
            continue
        # one-hop taint: `n = dist.get_world_size()` then `total * n`
        tainted: dict = {}
        for node in ast.walk(fdef):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                site = _topology_site(mod, node.value)
                if site:
                    tainted[node.targets[0].id] = site
        for node in ast.walk(fdef):
            if isinstance(node, ast.BinOp):
                exprs = [node.left, node.right]
            elif isinstance(node, ast.Subscript):
                exprs = [node.slice]
            else:
                continue
            for expr in exprs:
                for sub in ast.walk(expr):
                    full = _topology_site(mod, sub)
                    if not full and isinstance(sub, ast.Name):
                        full = tainted.get(sub.id, "")
                    if not full:
                        continue
                    rep.emit(
                        "DCFM2001", sub,
                        f"{full} feeds carry-shape/divisor "
                        f"arithmetic in '{fdef.name}' - elastic resume "
                        "restarts a checkpoint on a DIFFERENT topology "
                        "than the one that saved it, so window "
                        "divisors and per-chain shapes must flow from "
                        "the recorded checkpoint meta (topology / "
                        "chain_acc_starts / fold_draws, via "
                        "read_checkpoint_meta / elastic_meta), never "
                        "from live capacity.  A sanctioned site "
                        "carries an inline "
                        "`# dcfm: ignore[DCFM2001] - <why>`")


# =====================================================================
# DCFM002 - stale suppressions
# =====================================================================

class _PragmaSite:
    """Synthetic emit anchor for a pragma comment (no AST node exists
    for a comment; line/col come from the source text)."""

    def __init__(self, line: int, col: int):
        self.lineno = line
        self.col_offset = col


def _check_stale_pragmas(mod: _Module, rep: _Reporter) -> None:
    """DCFM002: every pragma must have suppressed at least one finding
    in this run.  MUST run after every other checker (it reads the
    reporter's used-ignore ledger).  A ``# dcfm-torch: ignore[...]`` is
    checked for every rule; a JAX-form ``# dcfm: ignore[...]`` for the
    rules whose detectors the two linters share (and unknown ids) - on a
    translated rule it addresses the JAX linter's detector, whose own
    gate (which lints the port's files too) judges it."""
    for line, col, form, rules in sorted(mod.pragmas,
                                         key=lambda p: (p[0], p[1])):
        for rule in sorted(rules):
            if (line, rule) in rep.used_ignores:
                continue
            if form == "dcfm" and rule in TRANSLATED:
                continue
            detail = ("names an unknown rule id"
                      if rule not in RULES and rule != "DCFM000"
                      else "no longer fires on this line")
            rep.emit("DCFM002", _PragmaSite(line, col),
                     f"stale suppression: '# {form}: ignore[{rule}]' "
                     f"{detail} - the pragma hides nothing today but "
                     "would mask a future regression; drop it")


# =====================================================================
# driver
# =====================================================================

def lint_source(source: str, path: str = "<string>",
                project=None) -> list:
    from dcfm_tpu_torch.analysis.lifetime import check_lifetime
    from dcfm_tpu_torch.analysis.locks import check_locks

    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 0, e.offset or 0, "DCFM000",
                        f"syntax error: {e.msg}")]
    mod = _Module(tree, source, path, project=project)
    rep = _Reporter(mod)
    _check_rng(mod, rep)
    _check_traced_bodies(mod, rep)
    _check_dtype_module(mod, rep)
    _check_ffi(mod, rep)
    _check_threads(mod, rep)
    _check_servers(mod, rep)
    _check_robustness(mod, rep)
    _check_multihost(mod, rep)
    _check_pipeline(mod, rep)
    _check_obs(mod, rep)
    _check_handlers(mod, rep)
    _check_poll_loops(mod, rep)
    check_locks(mod, rep, project)
    check_lifetime(mod, rep, project)
    _check_chain_reductions(mod, rep)
    _check_dense_quadratic(mod, rep)
    _check_precision_matmul(mod, rep)
    _check_partition_specs(mod, rep)
    _check_pointer_mutation(mod, rep)
    _check_topology_constants(mod, rep)
    _check_stale_pragmas(mod, rep)      # must stay last: reads the ledger
    rep.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return rep.findings


def lint_file(path: str, project=None) -> list:
    with open(path, "r", encoding="utf-8") as f:
        return lint_source(f.read(), path, project=project)


def lint_paths(paths: Iterable[str]) -> list:
    """Project-aware lint over files/directories: builds the cross-
    module symbol table first (analysis/engine.py), then lints each
    file with it.  Kept as the stable public entry point - the engine
    adds caching/baseline/SARIF on top for the CLI."""
    from dcfm_tpu_torch.analysis.engine import lint_project
    return lint_project(paths)
