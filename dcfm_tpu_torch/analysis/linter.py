"""AST linter core: JAX/FFI-aware checks over one module at a time.

Design: one :func:`lint_source` pass per file, no imports of the linted
code (pure ``ast``), no third-party dependencies.  Each rule family is a
separate checker over a shared :class:`_Module` context that pre-resolves
the things every family needs:

* import aliases (``jnp``/``np``/``jax.random``/``ctypes`` may be bound
  to anything; the checkers work on *resolved* dotted names),
* the set of **traced functions** - jit-decorated, ``jax.jit(f)``-wrapped,
  or passed to ``lax.scan/cond/while_loop/fori_loop/switch`` /
  ``jax.vmap/pmap`` - plus nested functions they call (propagated to
  siblings defined in the same scope, the ``run_chunk`` ->
  ``body``/``_body``/``accumulate`` structure),
* CDLL-tainted names for the FFI family (values flowing out of
  ``ctypes.CDLL`` through module globals and local helper returns).

False-positive posture: every rule errs toward silence.  The lint gate is
``dcfm-tpu lint dcfm_tpu/`` exiting 0 with no suppressions, so a rule
that cries wolf on sanctioned idioms (``fold_in`` site derivation, the
static-shape ``float()`` guards in ops/gamma.py, host-side ``np.float64``
diagnostics) would be deleted, not argued with.

The port's copy of ``dcfm_tpu/analysis/linter.py``: the same code, so the
same findings on the same source (held finding for finding by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Iterable, Optional

from dcfm_tpu_torch.analysis.rules import ALL_RULES, RULES

_IGNORE_RE = re.compile(r"#\s*dcfm:\s*ignore\[([A-Z0-9, ]+)\]")

# jax.random functions that CONSUME the key they are given (the key must
# not be used again).  fold_in/key/PRNGKey/clone DERIVE keys and are
# exempt: fold_in with distinct site constants is this repo's sanctioned
# key-derivation architecture (models/conditionals._shard_keys).
_RNG_CONSUMERS = {
    "split", "normal", "uniform", "gamma", "beta", "bernoulli", "cauchy",
    "categorical", "chisquare", "choice", "dirichlet", "double_sided_maxwell",
    "exponential", "f", "gumbel", "laplace", "loggamma", "logistic",
    "maxwell", "multivariate_normal", "orthogonal", "pareto", "permutation",
    "poisson", "rademacher", "randint", "rayleigh", "t", "truncated_normal",
    "weibull_min", "ball", "binomial", "geometric",
}
_RNG_DERIVERS = {"fold_in", "key", "PRNGKey", "wrap_key_data", "clone",
                 "key_data"}
_KEY_PARAM_RE = re.compile(
    r"^(key|keys|rng|rngs|rng_key|k|k_[A-Za-z0-9_]+|[A-Za-z0-9_]*_key)$")

# callees whose function arguments execute under trace
_TRACER_CALLERS = {"scan", "while_loop", "fori_loop", "cond", "switch",
                   "vmap", "pmap", "checkpoint", "remat", "associative_scan",
                   "pallas_call", "shard_map"}

_CONTIG_PRODUCERS = {"ascontiguousarray", "require", "zeros", "empty",
                     "ones", "full", "zeros_like", "empty_like",
                     "ones_like", "full_like"}

_HOST_SYNC_NP = {"asarray", "array", "ascontiguousarray", "save", "load",
                 "copy"}
_HOST_SYNC_METHODS = {"item", "tolist", "tobytes"}


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
    """'jax.random.split' for Attribute/Name chains, else None."""
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


class _Module:
    """Shared per-file context: aliases, traced-function set, taint.

    ``project`` is the optional cross-module symbol table built by
    analysis/engine.py (threaded classes, loader helpers, jit entries);
    single-file mode (``lint_file`` without a project) keeps every rule
    functional on in-module evidence alone.
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
        # directory named "runtime" (dcfm_tpu/runtime/), or whose stem
        # is "runtime" / ends in "_runtime" (the lint-fixture naming
        # convention).  Deliberately NOT a substring match: a module
        # like runtime_flags.py is ordinary library code and must not
        # be held to the pipeline's async-fetch discipline.
        parts = str(path).replace("\\", "/").split("/")
        stem = base[:-3] if base.endswith(".py") else base
        self.is_runtime = ("runtime" in parts[:-1] or stem == "runtime"
                           or stem.endswith("_runtime"))
        # Standalone scripts (scripts/, bench.py, the graft driver) are
        # operator entry points, not library code: library_only rules
        # (constant seeds, console prints, daemon helpers) skip them
        # exactly like test files - the whole-tree gate must not force
        # telemetry discipline onto demo drivers.
        self.is_script = ("scripts" in parts[:-1]
                          or stem in {"bench", "__graft_entry__"})
        self.ignores = self._collect_ignores()
        self.aliases: dict = {}
        self._collect_aliases()
        self.traced: set = set()
        self._collect_traced()

    def _collect_ignores(self) -> dict:
        """Pragmas from real COMMENT tokens only: a docstring or rule
        summary that merely *mentions* the ``# dcfm: ignore[...]``
        syntax is prose, not a suppression (and must not be flagged as
        a stale one by DCFM002)."""
        out: dict = {}
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO("\n".join(self.lines) + "\n").readline))
        except (tokenize.TokenError, IndentationError, SyntaxError):
            return out
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _IGNORE_RE.search(tok.string)
            if m:
                out[tok.start[0]] = {r.strip()
                                     for r in m.group(1).split(",")}
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
        ``from jax import random as r`` makes ``r.split`` resolve to
        ``jax.random.split``."""
        name = _dotted(node)
        if not name:
            return ""
        head, _, rest = name.partition(".")
        head = self.aliases.get(head, head)
        return f"{head}.{rest}" if rest else head

    def is_jax_random(self, call: ast.Call) -> Optional[str]:
        """The jax.random function name if this call targets one."""
        full = self.resolve(call.func)
        if full.startswith("jax.random."):
            tail = full.rsplit(".", 1)[-1]
            if tail in _RNG_CONSUMERS or tail in _RNG_DERIVERS:
                return tail
        return None

    # -- traced-function discovery ------------------------------------
    def _collect_traced(self) -> None:
        # function-definition tree: every def, keyed by nearest
        # enclosing def scope (module for top-level and class methods -
        # class bodies do not make a def scope).  One linear traversal;
        # the previous per-def ancestor walk was quadratic and dominated
        # whole-tree lint time.
        self._defs_by_scope: dict = {self.tree: {}}

        def collect(node: ast.AST, scope: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child,
                              (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self._defs_by_scope[scope][child.name] = child
                    self._defs_by_scope.setdefault(child, {})
                    collect(child, child)
                else:
                    collect(child, scope)

        collect(self.tree, self.tree)

        for scope, defs in self._defs_by_scope.items():
            for fdef in defs.values():
                for dec in getattr(fdef, "decorator_list", []):
                    flat = ast.dump(dec)
                    if "'jit'" in flat or "'pjit'" in flat:
                        self.traced.add(fdef)
        all_defs: dict = {}
        for defs in self._defs_by_scope.values():
            all_defs.update(defs)
        for node in ast.walk(self.tree):
            if not isinstance(node, ast.Call):
                continue
            tail = _last(self.resolve(node.func))
            if tail not in {"jit", "pjit"} and tail not in _TRACER_CALLERS:
                continue
            for arg in list(node.args) + [k.value for k in node.keywords]:
                if isinstance(arg, ast.Lambda):
                    self.traced.add(arg)
                elif isinstance(arg, ast.Name) and arg.id in all_defs:
                    self.traced.add(all_defs[arg.id])
                elif (isinstance(arg, ast.Call)
                      and _last(self.resolve(arg.func)) == "partial"):
                    for parg in arg.args:
                        if isinstance(parg, ast.Name) and parg.id in all_defs:
                            self.traced.add(all_defs[parg.id])
        # propagate to same-scope siblings the traced functions call
        # (run_chunk's scan body calls its sibling _body); module-level
        # helpers are NOT propagated into - that is what keeps the
        # statically-guarded float() in ops/gamma.py out of DCFM201.
        changed = True
        while changed:
            changed = False
            for scope, defs in self._defs_by_scope.items():
                for fdef in [d for d in defs.values() if d in self.traced]:
                    for call in ast.walk(fdef):
                        if (isinstance(call, ast.Call)
                                and isinstance(call.func, ast.Name)
                                and call.func.id in defs
                                and defs[call.func.id] not in self.traced):
                            self.traced.add(defs[call.func.id])
                            changed = True


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

@dataclasses.dataclass
class _KeyState:
    """Per-key consumption record along one control-flow path."""
    samplers: int = 0                  # direct jax.random sampler/split uses
    escapes: dict = dataclasses.field(default_factory=dict)  # callee -> n

    def copy(self) -> "_KeyState":
        return _KeyState(self.samplers, dict(self.escapes))

    def merge(self, other: "_KeyState") -> "_KeyState":
        esc = dict(self.escapes)
        for c, n in other.escapes.items():
            esc[c] = max(esc.get(c, 0), n)
        return _KeyState(max(self.samplers, other.samplers), esc)


class _KeyFlow:
    """Path-sensitive single-scope key-consumption counter.

    Tracks names bound to PRNG keys (key-producing assignments and
    key-looking parameters) and counts static *consumption* sites.  A
    key is violated when, along one path, it is (a) consumed by two
    jax.random sampler/``split`` calls, (b) passed twice into the SAME
    unknown callee, or (c) both sampled directly and passed into an
    unknown callee.  Passing one parent key into *distinct* helpers is
    exempt: that is this repo's sanctioned site-derivation architecture
    (gibbs_sweep/impute_missing_y/adapt_rank each ``fold_in`` a distinct
    ``_SITE_*`` constant from the same iteration key).  ``fold_in``
    itself derives, never consumes.  ``if``/``else`` branches count
    independently (a returning branch never merges with the fallthrough
    path); loop bodies are walked twice so a key consumed across
    iterations without re-derivation inside the loop is caught.  Nested
    function bodies are separate scopes (closure keys are not tracked
    there - by design, it keeps ``fit()``'s resume helpers quiet);
    lambdas are walked inline with parameter shadowing.
    """

    def __init__(self, mod: _Module, rep: _Reporter, scope: ast.AST):
        self.mod, self.rep = mod, rep
        self.scope = scope

    def run(self) -> None:
        counts: dict = {}
        args = getattr(self.scope, "args", None)
        if args is not None:
            for a in (args.posonlyargs + args.args + args.kwonlyargs):
                if _KEY_PARAM_RE.match(a.arg):
                    counts[a.arg] = _KeyState()
        body = self.scope.body if isinstance(self.scope.body, list) else [
            ast.Expr(self.scope.body)]
        self._stmts(body, counts)

    def _stmts(self, stmts, counts) -> bool:
        """Process a statement list; True if every path terminates."""
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue  # separate scope, analyzed on its own
            if isinstance(st, (ast.Return, ast.Raise)):
                v = getattr(st, "value", None) or getattr(st, "exc", None)
                if v is not None:
                    self._expr(v, counts)
                return True
            if isinstance(st, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                if st.value is not None:
                    self._expr(st.value, counts)
                targets = (st.targets if isinstance(st, ast.Assign)
                           else [st.target])
                self._rebind(targets, st.value, counts)
            elif isinstance(st, ast.If):
                self._expr(st.test, counts)
                c_body = {k: v.copy() for k, v in counts.items()}
                c_else = {k: v.copy() for k, v in counts.items()}
                t_body = self._stmts(st.body, c_body)
                t_else = self._stmts(st.orelse, c_else)
                live = [c for c, t in ((c_body, t_body), (c_else, t_else))
                        if not t]
                if not live:
                    return True
                merged: dict = {}
                for c in live:
                    for k, v in c.items():
                        merged[k] = merged[k].merge(v) if k in merged else v
                counts.clear()
                counts.update(merged)
            elif isinstance(st, (ast.For, ast.While)):
                self._expr(st.iter if isinstance(st, ast.For) else st.test,
                           counts)
                self._stmts(st.body, counts)
                self._stmts(st.body, counts)   # cross-iteration reuse
                self._stmts(st.orelse, counts)
            elif isinstance(st, ast.With):
                for item in st.items:
                    self._expr(item.context_expr, counts)
                if self._stmts(st.body, counts):
                    return True
            elif isinstance(st, ast.Try):
                self._stmts(st.body, counts)
                for h in st.handlers:
                    self._stmts(h.body,
                                {k: v.copy() for k, v in counts.items()})
                self._stmts(st.orelse, counts)
                self._stmts(st.finalbody, counts)
            elif isinstance(st, ast.Expr):
                self._expr(st.value, counts)
            else:
                for child in ast.iter_child_nodes(st):
                    if isinstance(child, ast.expr):
                        self._expr(child, counts)
        return False

    def _rebind(self, targets, value, counts) -> None:
        produced = self._is_key_producer(value)
        for t in targets:
            names = ([t.id] if isinstance(t, ast.Name) else
                     [e.id for e in getattr(t, "elts", [])
                      if isinstance(e, ast.Name)])
            for n in names:
                if produced:
                    counts[n] = _KeyState()   # fresh key(s): lineage resets
                elif n in counts:
                    del counts[n]             # rebound to a non-key value

    def _is_key_producer(self, value) -> bool:
        if not isinstance(value, ast.Call):
            return False
        fn = self.mod.is_jax_random(value)
        if fn == "split" or fn in _RNG_DERIVERS:
            return True
        return _last(self.mod.resolve(value.func)) == "chain_keys"

    def _expr(self, node, counts, shadow=frozenset()) -> None:
        if node is None:
            return
        if isinstance(node, ast.Lambda):
            inner = shadow | {a.arg for a in node.args.args}
            self._expr(node.body, counts, inner)
            return
        if isinstance(node, ast.Call):
            self._consume(node, counts, shadow)
        for child in ast.iter_child_nodes(node):
            self._expr(child, counts, shadow)

    def _consume(self, call, counts, shadow) -> None:
        fn = self.mod.is_jax_random(call)
        if fn is not None and fn != "split" and fn in _RNG_DERIVERS:
            return                        # derivation, not consumption
        full = self.mod.resolve(call.func)
        tail = _last(full)
        if fn is None and tail in {"eval_shape", "ShapeDtypeStruct",
                                   "key_data", "block_until_ready"}:
            return                        # shape/introspection only
        callee = full or f"<dynamic:{id(call.func)}>"
        for a in list(call.args) + [k.value for k in call.keywords]:
            if not (isinstance(a, ast.Name) and a.id in counts
                    and a.id not in shadow):
                continue
            st = counts[a.id]
            if fn is not None:            # direct sampler / split
                st.samplers += 1
                if st.samplers >= 2 or st.escapes:
                    self._flag(a)
            else:                         # escapes into an unknown callee
                st.escapes[callee] = st.escapes.get(callee, 0) + 1
                if st.escapes[callee] >= 2 or st.samplers:
                    self._flag(a)

    def _flag(self, node) -> None:
        self.rep.emit(
            "DCFM101", node,
            f"PRNG key '{node.id}' is consumed more than once on this "
            "path (two samplers, the same helper twice, or a sampler "
            "plus a helper) - derive a fresh key with split/fold_in "
            "before each consumption")


def _check_rng(mod: _Module, rep: _Reporter) -> None:
    scopes = [mod.tree] + [
        n for n in ast.walk(mod.tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        _KeyFlow(mod, rep, scope).run()
    # DCFM102: inline constant-seed key construction in library code,
    # except shape-only eval_shape arguments
    shape_only: set = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) and _last(
                mod.resolve(node.func)) in {"eval_shape",
                                            "ShapeDtypeStruct"}:
            for sub in ast.walk(node):
                shape_only.add(id(sub))
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or id(node) in shape_only:
            continue
        fn = mod.is_jax_random(node)
        if fn in {"key", "PRNGKey"} and node.args \
                and isinstance(node.args[0], ast.Constant):
            rep.emit("DCFM102", node,
                     f"jax.random.{fn}({node.args[0].value!r}) with a "
                     "constant seed in library code - thread the "
                     "caller's key/seed instead")


# =====================================================================
# DCFM2xx / DCFM3xx - jit hygiene and dtype drift
# =====================================================================

def _is_float64_dtype(mod: _Module, node: ast.AST) -> bool:
    if _last(mod.resolve(node)) in {"float64", "double"}:
        return True
    return (isinstance(node, ast.Constant)
            and node.value in ("float64", "double", ">f8", "<f8", "f8"))


def _check_traced_bodies(mod: _Module, rep: _Reporter) -> None:
    for fdef in mod.traced:
        # subtrees of nested defs that are NOT themselves traced are a
        # separate function - skip them here
        skip: set = set()
        for nd in ast.walk(fdef):
            if nd is fdef or not isinstance(
                    nd, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if nd not in mod.traced:
                for sub in ast.walk(nd):
                    skip.add(id(sub))
        tracerish = _tracerish_names(mod, fdef)
        for node in ast.walk(fdef):
            if id(node) in skip:
                continue
            if isinstance(node, ast.Call):
                _check_traced_call(mod, rep, node, tracerish)
            resolved = ""
            if isinstance(node, ast.Subscript):
                resolved = mod.resolve(node.value)
            elif isinstance(node, ast.Call):
                resolved = mod.resolve(node.func)
            if resolved in {"os.environ", "os.environ.get", "os.getenv"}:
                rep.emit("DCFM203", node,
                         "os.environ read inside a traced function is "
                         "baked in at trace time; read it outside the "
                         "jit and pass the value in")
            if isinstance(node, (ast.If, ast.While)):
                test = node.test
                if _is_static_test(test):
                    continue
                if _mentions(test, tracerish) or _has_jnp_call(mod, test):
                    rep.emit("DCFM202", node,
                             "Python control flow on a traced value "
                             "(ConcretizationError or silent trace-time "
                             "constant fold; use lax.cond / jnp.where)")


def _check_traced_call(mod, rep, node, tracerish) -> None:
    full = mod.resolve(node.func)
    tail = _last(full)
    head = full.split(".", 1)[0] if full else ""
    if head in {"numpy", "np"} and tail in _HOST_SYNC_NP:
        rep.emit("DCFM201", node,
                 f"numpy call '{full}' inside a traced function forces "
                 "a host sync (or fails at trace time); use jnp")
    elif full == "jax.device_get":
        rep.emit("DCFM201", node,
                 "jax.device_get inside a traced function")
    elif (isinstance(node.func, ast.Attribute)
          and node.func.attr in _HOST_SYNC_METHODS):
        rep.emit("DCFM201", node,
                 f".{node.func.attr}() inside a traced function "
                 "materializes the value on host")
    elif (isinstance(node.func, ast.Name)
          and node.func.id in {"float", "int", "bool"}
          and node.args and _mentions(node.args[0], tracerish)):
        rep.emit("DCFM201", node,
                 f"{node.func.id}() on a traced value forces a concrete "
                 "host value at trace time")
    for a in list(node.args) + [k.value for k in node.keywords]:
        if _is_float64_dtype(mod, a):
            rep.emit("DCFM301", a,
                     "float64 dtype inside a traced function (the TPU "
                     "path is float32 end to end)")
    if tail == "astype" and node.args and isinstance(
            node.args[0], ast.Name) and node.args[0].id == "float":
        rep.emit("DCFM302", node,
                 "astype(float) in traced code (float64 under x64; "
                 "pin jnp.float32)")
    for k in node.keywords:
        if k.arg == "dtype" and isinstance(k.value, ast.Name) \
                and k.value.id == "float":
            rep.emit("DCFM302", k.value,
                     "dtype=float in traced code (float64 under x64; "
                     "pin jnp.float32)")


def _tracerish_names(mod: _Module, fdef) -> set:
    """Names assigned (anywhere in the function) from expressions that
    contain a jnp/lax call - conservative 'this is an array value'
    marker for DCFM201/202."""
    out: set = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fdef):
            if not isinstance(node, ast.Assign):
                continue
            if _has_jnp_call(mod, node.value) or _mentions(node.value, out):
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in out:
                        out.add(t.id)
                        changed = True
    return out


def _has_jnp_call(mod: _Module, node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            full = mod.resolve(n.func)
            if full.startswith("jax.numpy.") or full.startswith("jax.lax.") \
                    or full.split(".", 1)[0] in {"jnp", "lax"}:
                return True
    return False


def _mentions(node: ast.AST, names: set) -> bool:
    return any(isinstance(n, ast.Name) and n.id in names
               for n in ast.walk(node))


def _is_static_test(test: ast.AST) -> bool:
    """Tests that are fine in traced code: None/isinstance/shape checks -
    static structure, not traced values."""
    if isinstance(test, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
        return True
    for n in ast.walk(test):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Name) \
                and n.func.id in {"isinstance", "hasattr", "len",
                                  "getattr", "callable"}:
            return True
    return False


def _check_dtype_module(mod: _Module, rep: _Reporter) -> None:
    """DCFM301/302 outside traced functions: float64 passed into jnp
    calls anywhere (host-side np.float64 diagnostics are deliberately
    fine - utils/diagnostics.py accumulates in double on purpose)."""
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Attribute) and mod.resolve(node) in {
                "jnp.float64", "jax.numpy.float64"}:
            rep.emit("DCFM301", node,
                     "jnp.float64 in library code - the TPU path is "
                     "float32 end to end")
        if not isinstance(node, ast.Call):
            continue
        full = mod.resolve(node.func)
        if not (full.startswith("jnp.") or full.startswith("jax.numpy.")):
            continue
        for a in list(node.args) + [k.value for k in node.keywords]:
            if _is_float64_dtype(mod, a):
                rep.emit("DCFM301", a,
                         f"float64 dtype passed to {full} - drifts the "
                         "float32 TPU path to double precision")
        for k in node.keywords:
            if k.arg == "dtype" and isinstance(k.value, ast.Name) \
                    and k.value.id == "float":
                rep.emit("DCFM302", k.value,
                         f"dtype=float passed to {full} (float64 under "
                         "x64; pin jnp.float32)")


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
# DCFM7xx - multi-host discipline
# =====================================================================

# Calls that mark a function as multi-host-aware: it branches on (or
# gathers across) the process topology, so arrays flowing through it
# can be non-fully-addressable global arrays.
_MULTIHOST_MARKER_FULL = {"jax.process_index", "jax.process_count"}
_MULTIHOST_MARKER_TAILS = {"process_allgather", "broadcast_one_to_all",
                           "sync_global_devices"}
# Referencing any of these in the same function counts as addressing
# the shard-locality question - the guard the rule demands.
_ADDRESSABILITY_ATTRS = {"is_fully_addressable", "is_fully_replicated",
                         "addressable_shards", "addressable_data"}


def _check_multihost(mod: _Module, rep: _Reporter) -> None:
    """DCFM701: function-granular like the FFI contiguity rule, and
    nested-def-exclusive (a nested helper is its own function with its
    own markers): in a multi-host-aware function with no addressability
    reference, flag ``jax.device_get`` on an array variable
    (Name/Attribute argument - a jit output fetched inline is the
    caller's explicit choice) and ``np.asarray`` on a bare Name (list
    literals building collective payloads are fine)."""
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        skip: set = set()
        for nd in ast.walk(fdef):
            if nd is not fdef and isinstance(
                    nd, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(nd):
                    skip.add(id(sub))
        own = [n for n in ast.walk(fdef) if id(n) not in skip]
        marked = False
        guarded = False
        for n in own:
            if isinstance(n, ast.Call):
                full = mod.resolve(n.func)
                if (full in _MULTIHOST_MARKER_FULL
                        or _last(full) in _MULTIHOST_MARKER_TAILS):
                    marked = True
            if isinstance(n, ast.Attribute) \
                    and n.attr in _ADDRESSABILITY_ATTRS:
                guarded = True
        if not marked or guarded:
            continue
        for n in own:
            if not isinstance(n, ast.Call) or not n.args:
                continue
            full = mod.resolve(n.func)
            arg = n.args[0]
            if full == "jax.device_get" and isinstance(
                    arg, (ast.Name, ast.Attribute)):
                rep.emit("DCFM701", n,
                         "jax.device_get on an array variable in a "
                         "multi-host-aware function with no "
                         "addressability guard - non-fully-addressable "
                         "global arrays cannot be device_get; fetch "
                         "addressable shards, or guard on "
                         "is_fully_addressable")
            elif (full in {"numpy.asarray", "numpy.array"}
                  and isinstance(arg, ast.Name)):
                rep.emit("DCFM701", n,
                         f"{_last(full)} on '{arg.id}' in a multi-host-"
                         "aware function with no addressability guard - "
                         "materializing a non-fully-addressable global "
                         "array on host raises; fetch addressable "
                         "shards, or guard on is_fully_addressable")


# =====================================================================
# DCFM8xx - runtime pipeline discipline
# =====================================================================

def _check_pipeline(mod: _Module, rep: _Reporter) -> None:
    """DCFM801: blocking host fetch in a runtime pipeline module with no
    preceding ``copy_to_host_async`` in the same function.

    Scope is the runtime package only (``mod.is_runtime`` - path-gated,
    so api/serve code is untouched), function-granular and nested-def-
    exclusive like DCFM701, and PRECEDENCE-aware: a fetch on a line at
    or after the function's first ``copy_to_host_async`` dispatch is the
    sanctioned drain half of an async pair; one before any dispatch is
    the serializing sync fetch the rule hunts.  Argument shapes mirror
    DCFM701 (``jax.device_get`` on Name/Attribute, ``np.asarray`` /
    ``np.array`` on a bare Name) so jit-output fetches chosen inline and
    list-literal payloads stay quiet."""
    if not mod.is_runtime:
        return
    for fdef in ast.walk(mod.tree):
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        skip: set = set()
        for nd in ast.walk(fdef):
            if nd is not fdef and isinstance(
                    nd, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for sub in ast.walk(nd):
                    skip.add(id(sub))
        own = [n for n in ast.walk(fdef) if id(n) not in skip]
        async_lines = [
            n.lineno for n in own
            if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "copy_to_host_async"]
        first_async = min(async_lines, default=None)
        for n in own:
            if not isinstance(n, ast.Call) or not n.args:
                continue
            if first_async is not None and n.lineno >= first_async:
                continue
            full = mod.resolve(n.func)
            arg = n.args[0]
            if full == "jax.device_get" and isinstance(
                    arg, (ast.Name, ast.Attribute)):
                rep.emit("DCFM801", n,
                         "jax.device_get in a runtime pipeline function "
                         "with no preceding copy_to_host_async - a "
                         "blocking fetch here serializes the chain "
                         "behind the device->host link; dispatch the "
                         "async copy at the chunk boundary and drain "
                         "off-thread (StreamingFetcher), or annotate "
                         "the deliberate sync fetch")
            elif (full in {"numpy.asarray", "numpy.array"}
                  and isinstance(arg, ast.Name)):
                rep.emit("DCFM801", n,
                         f"{_last(full)} on '{arg.id}' in a runtime "
                         "pipeline function with no preceding "
                         "copy_to_host_async - a blocking fetch here "
                         "serializes the chain behind the device->host "
                         "link; dispatch the async copy first, or "
                         "annotate the deliberate sync fetch")


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


def _bare_axis0(call: ast.Call) -> bool:
    """True when the reduction collapses the leading axis implicitly:
    no axis argument at all, or a bare literal ``axis=0``.  An axis
    spelled any other way (a named constant, a non-zero index, a tuple)
    counts as the author naming the axis deliberately."""
    for kw in call.keywords:
        if kw.arg == "axis":
            return (isinstance(kw.value, ast.Constant)
                    and kw.value.value == 0)
    return True


def _check_chain_reductions(mod: _Module, rep: _Reporter) -> None:
    """DCFM1401: a host reduction over a chain-major array without the
    chain axis named.  Trace blocks, pooled Sigma, and draws are ALWAYS
    chain-major (single-chain runs carry a length-1 leading axis), so a
    bare ``.mean(axis=0)`` on a name containing 'chain' conflates
    'average over chains' with 'average over draws'.  Functions whose
    own name contains 'chain' (pool_chains, _pool_chain_axis) ARE the
    sanctioned seam and are skipped."""

    def visit(node: ast.AST, in_chain_fn: bool) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, in_chain_fn
                      or "chain" in child.name.lower())
                continue
            if isinstance(child, ast.Call) and not in_chain_fn:
                target = None
                fn = mod.resolve(child.func)
                if fn in ("numpy.mean", "numpy.sum") and child.args:
                    target = child.args[0]
                elif (isinstance(child.func, ast.Attribute)
                        and child.func.attr in ("mean", "sum")):
                    target = child.func.value
                if (target is not None and _chain_name(target)
                        and _bare_axis0(child)):
                    rep.emit(
                        "DCFM1401", child,
                        "host reduction over a chain-major array "
                        "collapses the leading chain axis implicitly "
                        "(bare axis=0 / no axis) - pool through "
                        "pool_chains()/_pool_chain_axis() or name the "
                        "chain axis in the reducing helper")
            visit(child, in_chain_fn)

    visit(mod.tree, False)


# =====================================================================
# DCFM1501 - dense-quadratic materialization
# =====================================================================

_ALLOC_FNS = frozenset(
    f"{m}.{a}" for m in ("numpy", "jax.numpy")
    for a in ("zeros", "empty", "ones", "full"))


def _check_dense_quadratic(mod: _Module, rep: _Reporter) -> None:
    """DCFM1501: an allocation whose shape tuple repeats a symbolic
    dimension - the (p, p) / (pairs, P, P) dense-buffer signature.  At
    the scale-out shapes the streaming ingest targets (p >= 1e6) such a
    buffer is hundreds of GB of host RAM, so library code routes
    through the packed-panel seams; the handful of sanctioned assembly
    sites (force=True restores, the reference implementation, device-
    side packed accumulators) carry inline pragmas.  Constant dims are
    ignored: np.zeros((3, 3)) repeats no *symbol*."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        if mod.resolve(node.func) not in _ALLOC_FNS:
            continue
        shape = node.args[0]
        if not isinstance(shape, ast.Tuple) or len(shape.elts) < 2:
            continue
        dims = [(ast.dump(e), getattr(e, "lineno", None))
                for e in shape.elts if not isinstance(e, ast.Constant)]
        seen: dict = {}
        repeated = None
        for dump, _ in dims:
            if dump in seen:
                repeated = dump
                break
            seen[dump] = True
        if repeated is None:
            continue
        try:
            dim_src = ast.unparse(
                next(e for e in shape.elts
                     if not isinstance(e, ast.Constant)
                     and ast.dump(e) == repeated))
        except Exception:  # dcfm: ignore[DCFM601] - cosmetic unparse only; the finding still emits
            dim_src = "<dim>"
        rep.emit(
            "DCFM1501", node,
            f"shape tuple repeats the symbolic dimension '{dim_src}' - "
            "a dense O(d^2) buffer that is hundreds of GB at the "
            "scale-out shapes (p >= 1e6) the streaming ingest "
            "supports.  Route through the packed-panel / sigma_block / "
            "artifact seams, or annotate a sanctioned assembly site "
            "with `# dcfm: ignore[DCFM1501] - <why>`")


# =====================================================================
# DCFM16xx - mixed-precision discipline
# =====================================================================

_LOWP_DTYPES = {"jnp.bfloat16", "jax.numpy.bfloat16",
                "jnp.float16", "jax.numpy.float16"}
_LOWP_STRS = {"bfloat16", "float16", "bf16", "fp16"}
_MATMUL_FNS = {"jnp.dot", "jax.numpy.dot",
               "jnp.matmul", "jax.numpy.matmul",
               "jnp.einsum", "jax.numpy.einsum",
               "jnp.tensordot", "jax.numpy.tensordot"}


def _is_lowp_dtype_expr(mod: _Module, node) -> bool:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value in _LOWP_STRS
    return mod.resolve(node) in _LOWP_DTYPES


def _is_lowp_cast(mod: _Module, node) -> bool:
    """``x.astype(jnp.bfloat16)`` / ``jnp.asarray(x, dtype='float16')``
    and friends - an expression that PRODUCES a low-precision array."""
    if not isinstance(node, ast.Call):
        return False
    if (isinstance(node.func, ast.Attribute) and node.func.attr == "astype"
            and node.args and _is_lowp_dtype_expr(mod, node.args[0])):
        return True
    full = mod.resolve(node.func)
    if full.startswith("jnp.") or full.startswith("jax.numpy."):
        for k in node.keywords:
            if k.arg == "dtype" and _is_lowp_dtype_expr(mod, k.value):
                return True
    return False


def _check_precision_matmul(mod: _Module, rep: _Reporter) -> None:
    """DCFM1601: a contraction over bf16/f16-cast operands without
    ``preferred_element_type`` accumulates in the LOW precision - the
    one way the mixed-precision sweep (BackendConfig.compute_dtype=
    "bf16") can silently void its accuracy contract, since every other
    piece (state, RNG, K x K factorizations) stays f32 by construction.

    Taint is name-based per module: names assigned from a low-precision
    cast anywhere in the file, plus inline cast expressions used
    directly as operands.  Scope-blind on purpose - a name that holds
    bf16 in ANY scope deserves the annotation everywhere it is
    contracted; shadowing false positives carry an inline pragma."""
    tainted: set = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign) and _is_lowp_cast(mod, node.value):
            for t in node.targets:
                if isinstance(t, ast.Name):
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
                    "`@` on a bfloat16/float16-cast operand accumulates "
                    "in the low input precision - use jnp.matmul(..., "
                    "preferred_element_type=jnp.float32) (the "
                    "models/conditionals.py `mm` pattern)")
        elif isinstance(node, ast.Call):
            full = mod.resolve(node.func)
            if full not in _MATMUL_FNS:
                continue
            if any(k.arg == "preferred_element_type"
                   for k in node.keywords):
                continue
            if any(lowp_operand(a) for a in node.args):
                rep.emit(
                    "DCFM1601", node,
                    f"{full} on a bfloat16/float16-cast operand without "
                    "preferred_element_type - the contraction "
                    "accumulates in the low input precision; pass "
                    "preferred_element_type=jnp.float32 so only the "
                    "MULTIPLY runs low-precision (f32 accumulation, "
                    "README 'Precision policy')")


# =====================================================================
# DCFM17xx - partition-rule conformance
# =====================================================================

_SPEC_CTORS = {"jax.sharding.PartitionSpec", "jax.sharding.NamedSharding",
               "jax.P", "jax.NamedSharding"}


def _check_partition_specs(mod: _Module, rep: _Reporter) -> None:
    """DCFM1701: PartitionSpec/NamedSharding constructed outside
    parallel/mesh.py's rule table.  ROADMAP item 5: partitioning
    decisions collapse onto the ONE name-keyed table
    (match_partition_rules plus the shard_sharding /
    replicated_sharding / named_shardings helpers), so a placement
    change edits one file and the trace gate can audit every spec.
    parallel/mesh.py itself - the table's home - is exempt."""
    parts = str(mod.path).replace("\\", "/").split("/")
    if parts[-1] == "mesh.py" and len(parts) >= 2 \
            and parts[-2] == "parallel":
        return
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        full = mod.resolve(node.func)
        if full not in _SPEC_CTORS:
            continue
        ctor = full.rsplit(".", 1)[-1]
        rep.emit(
            "DCFM1701", node,
            f"{ctor}(...) constructed outside parallel/mesh.py's rule "
            "table - partitioning decisions live in ONE place "
            "(match_partition_rules / carry_partition_rules and the "
            "shard_sharding / replicated_sharding / named_shardings "
            "helpers) so a placement change edits one file and the "
            "trace gate audits every spec.  Route through a mesh.py "
            "helper, or annotate a sanctioned one-off with "
            "`# dcfm: ignore[DCFM1701] - <why>`")


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

_TOPOLOGY_CALLS = {"jax.device_count", "jax.local_device_count",
                   "jax.process_count", "jax.devices"}
# Function-name hints that put a def on the resume/checkpoint carry
# path.  Deliberately function-scoped, not module-scoped: mesh sizing
# and launch-time capacity probes legitimately read live topology, and
# the hazard is specifically arithmetic that must survive a restart on
# DIFFERENT capacity (elastic resume, README "Elastic execution").
_RESUME_HINTS = ("resume", "checkpoint", "rewind", "restore",
                 "carryover", "elastic", "window", "warm")


def _topology_site(mod: _Module, node: ast.AST) -> str:
    """The dotted jax topology query when ``node`` is one (a direct
    call; ``len(jax.devices())`` is caught via the inner call when the
    enclosing expression is walked), else ''."""
    if not isinstance(node, ast.Call):
        return ""
    full = mod.resolve(node.func)
    return full if full in _TOPOLOGY_CALLS else ""


def _check_topology_constants(mod: _Module, rep: _Reporter) -> None:
    """DCFM2001: live topology queries feeding carry-shape or
    window-divisor arithmetic inside resume/checkpoint-path functions.
    Elastic resume restarts a checkpoint on a DIFFERENT capacity than
    the one that saved it: a shape or divisor derived from
    jax.device_count()/jax.process_count()/len(jax.devices()) silently
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
        # one-hop taint: `n = jax.process_count()` then `total * n`
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
                        f"{full}() feeds carry-shape/divisor "
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
    """DCFM002: every ``# dcfm: ignore[RULE]`` must have suppressed at
    least one finding in this run.  MUST run after every other checker
    (it reads the reporter's used-ignore ledger)."""
    for line, rules in sorted(mod.ignores.items()):
        text = mod.lines[line - 1] if 0 < line <= len(mod.lines) else ""
        m = _IGNORE_RE.search(text)
        col = m.start() if m else 0
        for rule in sorted(rules):
            if (line, rule) in rep.used_ignores:
                continue
            detail = ("names an unknown rule id"
                      if rule not in RULES and rule != "DCFM000"
                      else "no longer fires on this line")
            rep.emit("DCFM002", _PragmaSite(line, col),
                     f"stale suppression: '# dcfm: ignore[{rule}]' "
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
