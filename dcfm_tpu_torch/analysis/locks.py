"""DCFM11xx - lockset race detection over class instance state.

Eraser-style lockset analysis, scoped the way this codebase actually
uses threads: shared mutable state lives on ``self``, guarded by
``with self._lock:`` blocks (or explicit ``.acquire()``/``.release()``
pairs), and the thread population is spawned with
``threading.Thread(target=self._method)`` or arrives through the
socketserver handler machinery.

Per class, every access to every ``self.<attr>`` is recorded together
with the set of locks statically held at that point.  An attribute is
flagged (DCFM1101) when

* the class is *concurrency-aware*: it spawns a thread on one of its
  own methods, is a handler class, owns a lock attribute, or the
  project-wide symbol table saw one of its methods used as a Thread
  target from another module, AND
* some access site holds a lock (somebody thinks it needs guarding), AND
* the intersection of held locksets over all access sites outside
  ``__init__`` is empty (no single lock protects it), AND
* at least one of those sites is a write (the attribute actually
  mutates at runtime - read-only config set in ``__init__`` is fine).

Code inside nested functions/lambdas defined in a method body runs
*later*, usually on another thread (worker loops, metric-sampler
lambdas), so its accesses are recorded with an EMPTY lockset - holding
a lock while *defining* a callback guards nothing about its execution.

Attributes bound to thread-safe primitives (Lock/Event/Queue/deque...)
are exempt: their methods synchronize internally.  So are the lock
attributes themselves.

DCFM1102 records, module-wide, every ordered pair (held A, acquiring
B); if both (A, B) and (B, A) are observed the module contains an ABBA
inversion and the second order is flagged.

False-positive posture matches the rest of the linter: when in doubt,
stay silent - the gate is dcfm_tpu/ linting clean with justified
pragmas only.

The port's copy of ``dcfm_tpu/analysis/locks.py``: the same code, so the
same findings on the same source (held finding for finding by
tests/test_torch_analysis.py).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Optional

# constructors whose results are internally synchronized (or are plain
# thread handles) - attribute access on them needs no extra guard
_SAFE_CTOR_TAILS = {
    "Lock", "RLock", "Condition", "Event", "Semaphore", "BoundedSemaphore",
    "Barrier", "Queue", "SimpleQueue", "LifoQueue", "PriorityQueue",
    "deque", "local", "Thread", "Timer", "ThreadPoolExecutor",
}
# the subset usable as a `with`-acquirable guard
_LOCK_CTOR_TAILS = {"Lock", "RLock", "Condition"}

# method calls that mutate their receiver (container writes) - these
# count as writes for the "does the attribute actually change" gate
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "discard", "remove", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "sort", "reverse",
}

_HANDLER_BASE_TAILS = {
    "BaseHTTPRequestHandler", "SimpleHTTPRequestHandler",
    "StreamRequestHandler", "DatagramRequestHandler", "BaseRequestHandler",
    "ThreadingMixIn",
}


@dataclasses.dataclass
class _Access:
    attr: str
    write: bool
    locks: frozenset
    deferred: bool          # inside a nested def/lambda (runs later)
    method: str
    node: ast.AST


def _last(name: Optional[str]) -> str:
    return name.rsplit(".", 1)[-1] if name else ""


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for a ``self.x`` attribute node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _lock_token(mod, expr: ast.AST, lock_attrs: set,
                module_locks: set) -> Optional[str]:
    """Stable name for a known lock expression: 'self._lock' for a
    class lock attribute, the bare name for a module-level lock."""
    a = _self_attr(expr)
    if a is not None and a in lock_attrs:
        return f"self.{a}"
    if isinstance(expr, ast.Name) and expr.id in module_locks:
        return expr.id
    return None


class _ClassScan:
    """One class: lock/safe attribute discovery + per-method lockset walk."""

    def __init__(self, mod, cls: ast.ClassDef, module_locks: set):
        self.mod = mod
        self.cls = cls
        self.module_locks = module_locks
        self.lock_attrs: set = set()
        self.safe_attrs: set = set()
        self.accesses: list = []
        self.order_pairs: dict = {}     # (tokA, tokB) -> acquiring node
        self.thread_targets: set = set()  # own methods used as targets
        self._discover_attr_kinds()

    # -- discovery ----------------------------------------------------
    def _discover_attr_kinds(self) -> None:
        for n in ast.walk(self.cls):
            if not isinstance(n, ast.Assign):
                continue
            if not isinstance(n.value, ast.Call):
                continue
            tail = _last(self.mod.resolve(n.value.func))
            for t in n.targets:
                a = _self_attr(t)
                if a is None:
                    continue
                if tail in _LOCK_CTOR_TAILS:
                    self.lock_attrs.add(a)
                if tail in _SAFE_CTOR_TAILS:
                    self.safe_attrs.add(a)

    def concurrency_aware(self, project=None) -> Optional[str]:
        """Why this class's methods run on multiple threads (None = no
        evidence; the lockset rule then stays silent)."""
        for base in self.cls.bases:
            if _last(self.mod.resolve(base)) in _HANDLER_BASE_TAILS:
                return f"subclasses {_last(self.mod.resolve(base))}"
        for n in ast.walk(self.cls):
            if isinstance(n, ast.Call) and _last(
                    self.mod.resolve(n.func)) == "Thread":
                for k in n.keywords:
                    if k.arg == "target":
                        a = _self_attr(k.value)
                        if a is not None:
                            self.thread_targets.add(a)
        if self.thread_targets:
            names = ", ".join(sorted(self.thread_targets))
            return f"spawns worker thread(s) on {names}"
        if project is not None and self.cls.name in getattr(
                project, "threaded_classes", ()):
            return ("has methods used as Thread targets elsewhere in "
                    "the project")
        if self.lock_attrs:
            return "owns a lock (self-declared shared state)"
        return None

    # -- the lockset walk ---------------------------------------------
    def scan(self) -> None:
        for meth in self.cls.body:
            if isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_stmts(meth.body, frozenset(), meth.name,
                                 deferred=False)

    def _acquire(self, held: frozenset, tok: str,
                 node: ast.AST) -> frozenset:
        for h in held:
            if h != tok:
                self.order_pairs.setdefault((h, tok), node)
        return held | {tok}

    def _walk_stmts(self, stmts, held: frozenset, method: str,
                    deferred: bool) -> frozenset:
        for st in stmts:
            held = self._walk_stmt(st, held, method, deferred)
        return held

    def _walk_stmt(self, st, held: frozenset, method: str,
                   deferred: bool) -> frozenset:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, usually on another thread
            self._walk_stmts(st.body, frozenset(), method, deferred=True)
            for d in st.args.defaults + [
                    d for d in st.args.kw_defaults if d is not None]:
                self._scan_expr(d, held, method, deferred)
            return held
        if isinstance(st, ast.ClassDef):
            return held
        if isinstance(st, ast.With):
            inner = held
            for item in st.items:
                tok = _lock_token(self.mod, item.context_expr,
                                  self.lock_attrs, self.module_locks)
                if tok is not None:
                    inner = self._acquire(inner, tok, item.context_expr)
                else:
                    self._scan_expr(item.context_expr, inner, method,
                                    deferred)
            self._walk_stmts(st.body, inner, method, deferred)
            return held
        if isinstance(st, ast.If):
            self._scan_expr(st.test, held, method, deferred)
            self._walk_stmts(st.body, held, method, deferred)
            self._walk_stmts(st.orelse, held, method, deferred)
            return held
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._scan_expr(st.iter, held, method, deferred)
            self._record_target(st.target, held, method, deferred)
            self._walk_stmts(st.body, held, method, deferred)
            self._walk_stmts(st.orelse, held, method, deferred)
            return held
        if isinstance(st, ast.While):
            self._scan_expr(st.test, held, method, deferred)
            self._walk_stmts(st.body, held, method, deferred)
            self._walk_stmts(st.orelse, held, method, deferred)
            return held
        if isinstance(st, ast.Try):
            h = self._walk_stmts(st.body, held, method, deferred)
            for hd in st.handlers:
                self._walk_stmts(hd.body, held, method, deferred)
            self._walk_stmts(st.orelse, h, method, deferred)
            h = self._walk_stmts(st.finalbody, h, method, deferred)
            return h
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if st.value is not None:
                self._scan_expr(st.value, held, method, deferred)
            targets = (st.targets if isinstance(st, ast.Assign)
                       else [st.target])
            for t in targets:
                self._record_target(t, held, method, deferred)
            return held
        if isinstance(st, ast.Expr):
            return self._scan_expr(st.value, held, method, deferred)
        if isinstance(st, ast.Return) and st.value is not None:
            self._scan_expr(st.value, held, method, deferred)
            return held
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._scan_expr(child, held, method, deferred)
            elif isinstance(child, ast.stmt):
                held = self._walk_stmt(child, held, method, deferred)
        return held

    def _record_target(self, t, held, method, deferred) -> None:
        a = _self_attr(t)
        if a is not None:
            self._record(a, True, held, method, deferred, t)
            return
        if isinstance(t, (ast.Subscript, ast.Attribute)):
            # self.x[k] = v  /  self.x.y = v : container/field write on x
            base = t.value
            ba = _self_attr(base)
            if ba is not None:
                self._record(ba, True, held, method, deferred, base)
            else:
                self._scan_expr(base, held, method, deferred)
            if isinstance(t, ast.Subscript):
                self._scan_expr(t.slice, held, method, deferred)
            return
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._record_target(e, held, method, deferred)

    def _scan_expr(self, node, held: frozenset, method: str,
                   deferred: bool) -> frozenset:
        if node is None:
            return held
        if isinstance(node, ast.Lambda):
            self._scan_expr(node.body, frozenset(), method, deferred=True)
            return held
        if isinstance(node, ast.Call):
            # self._lock.acquire() / .release() adjust the linear lockset
            if isinstance(node.func, ast.Attribute):
                tok = _lock_token(self.mod, node.func.value,
                                  self.lock_attrs, self.module_locks)
                if tok is not None and node.func.attr == "acquire":
                    return self._acquire(held, tok, node)
                if tok is not None and node.func.attr == "release":
                    return frozenset(h for h in held if h != tok)
                # mutating method call on a self attribute is a write
                recv = _self_attr(node.func.value)
                if recv is not None:
                    self._record(recv, node.func.attr in _MUTATOR_METHODS,
                                 held, method, deferred, node.func.value)
                    for a in list(node.args) + [k.value
                                                for k in node.keywords]:
                        held = self._scan_expr(a, held, method, deferred)
                    return held
            for child in ast.iter_child_nodes(node):
                held = self._scan_expr(child, held, method, deferred)
            return held
        a = _self_attr(node)
        if a is not None:
            self._record(a, False, held, method, deferred, node)
            return held
        for child in ast.iter_child_nodes(node):
            held = self._scan_expr(child, held, method, deferred)
        return held

    def _record(self, attr: str, write: bool, held: frozenset,
                method: str, deferred: bool, node: ast.AST) -> None:
        self.accesses.append(_Access(
            attr, write, frozenset() if deferred else held, deferred,
            method, node))


def _module_lock_names(mod) -> set:
    out: set = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            if _last(mod.resolve(n.value.func)) in _LOCK_CTOR_TAILS:
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        out.add(t.id)
    return out


def collect_threaded_classes(mod) -> set:
    """Cross-module symbol-table contribution: resolved dotted names of
    classes whose methods this module hands to threading.Thread (an
    instance is constructed, then ``Thread(target=inst.method)``)."""
    inst_class: dict = {}
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
            cls = mod.resolve(n.value.func)
            if cls and _last(cls)[:1].isupper():
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        inst_class[t.id] = cls
    out: set = set()
    for n in ast.walk(mod.tree):
        if isinstance(n, ast.Call) and _last(
                mod.resolve(n.func)) == "Thread":
            for k in n.keywords:
                if (k.arg == "target"
                        and isinstance(k.value, ast.Attribute)
                        and isinstance(k.value.value, ast.Name)
                        and k.value.value.id in inst_class):
                    cls = inst_class[k.value.value.id]
                    out.add(cls)
                    out.add(_last(cls))
    return out


def check_locks(mod, rep, project=None) -> None:
    """DCFM1101 + DCFM1102 over one module (with optional project-wide
    threaded-class table)."""
    module_locks = _module_lock_names(mod)
    all_pairs: dict = {}
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        scan = _ClassScan(mod, cls, module_locks)
        why = scan.concurrency_aware(project)
        scan.scan()
        for pair, node in scan.order_pairs.items():
            all_pairs.setdefault(pair, node)
        if why is None:
            continue
        _flag_inconsistent(mod, rep, cls.name, scan, why)
    # module-level functions contribute lock-order pairs too
    _module_order_pairs(mod, module_locks, all_pairs)
    _flag_inversions(rep, all_pairs)


def _flag_inconsistent(mod, rep, cls_name, scan: _ClassScan,
                       why: str) -> None:
    by_attr: dict = {}
    for a in scan.accesses:
        if a.method in ("__init__", "__del__"):
            continue
        if a.attr in scan.lock_attrs or a.attr in scan.safe_attrs:
            continue
        by_attr.setdefault(a.attr, []).append(a)
    for attr, accs in sorted(by_attr.items()):
        if not any(a.write for a in accs):
            continue
        guarded = [a for a in accs if a.locks]
        if not guarded:
            continue                      # nobody guards it: not a lockset
        common = frozenset.intersection(*[a.locks for a in accs])
        if common:
            continue                      # one lock covers every access
        # the flagged site: the first access missing the majority lock
        lock_votes: dict = {}
        for a in guarded:
            for tok in a.locks:
                lock_votes[tok] = lock_votes.get(tok, 0) + 1
        guard = max(sorted(lock_votes), key=lambda t: lock_votes[t])
        bare = [a for a in accs if guard not in a.locks]
        site = min(bare, key=lambda a: getattr(a.node, "lineno", 0))
        g_site = min(guarded, key=lambda a: getattr(a.node, "lineno", 0))
        kind = "written" if site.write else "read"
        where = (" (in a callback/nested function that runs without the "
                 "lock)" if site.deferred else "")
        rep.emit(
            "DCFM1101", site.node,
            f"'self.{attr}' of {cls_name} is guarded by {guard} at line "
            f"{getattr(g_site.node, 'lineno', 0)} "
            f"({g_site.method}) but {kind} here in {site.method} without "
            f"it{where} - {cls_name} {why}, so the lockset for this "
            "attribute is empty (a data race); hold the same lock on "
            "every access or document the benign race")


def _module_order_pairs(mod, module_locks: set, all_pairs: dict) -> None:
    """Lock-order pairs from module-level functions (`with a: with b:`
    on module-level locks)."""

    def walk(stmts, held):
        for st in stmts:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(st.body, frozenset())
                continue
            if isinstance(st, ast.With):
                inner = held
                for item in st.items:
                    tok = _lock_token(mod, item.context_expr, set(),
                                      module_locks)
                    if tok is not None:
                        for h in inner:
                            if h != tok:
                                all_pairs.setdefault((h, tok),
                                                     item.context_expr)
                        inner = inner | {tok}
                walk(st.body, inner)
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.stmt):
                    walk([child], held)
                elif isinstance(child, list):
                    walk([c for c in child if isinstance(c, ast.stmt)],
                         held)

    walk(mod.tree.body, frozenset())


def _flag_inversions(rep, all_pairs: dict) -> None:
    seen: set = set()
    for (a, b), node in sorted(
            all_pairs.items(),
            key=lambda kv: getattr(kv[1], "lineno", 0)):
        if (b, a) not in all_pairs:
            continue
        key = frozenset((a, b))
        if key in seen:
            continue
        seen.add(key)
        other = all_pairs[(b, a)]
        first, second = sorted(
            [((a, b), node), ((b, a), other)],
            key=lambda kv: getattr(kv[1], "lineno", 0))
        (o1, o2), site = second
        rep.emit(
            "DCFM1102", site,
            f"lock-order inversion: {o1} is held while acquiring {o2} "
            f"here, but line {getattr(first[1], 'lineno', 0)} acquires "
            f"them in the opposite order - two threads interleaving "
            "these paths deadlock (ABBA); pick one global order")
