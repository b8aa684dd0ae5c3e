"""Rule registry: one place that names every rule the linter can emit.

The linter (analysis/linter.py) imports nothing from here at check time -
rules are emitted by ID string - but the registry is the documentation
the CLI's ``--list-rules`` prints and the README section is generated
from, and the fixture tests assert that every registered rule has at
least one known-bad fixture that fires it.

``library_only`` rules are skipped for test files (``test_*.py`` /
``conftest.py``) and standalone scripts (``scripts/``, ``bench.py``,
the graft entry): tests legitimately use constant seeds and daemon
helper threads, and demo scripts print to the console by design;
library code must not.

``severity`` feeds the CLI exit-code contract: ``error`` findings fail
the build (exit 1); ``warning`` findings (suppression rot, style-grade
drift) are reported but only fail under ``--fail-on warning`` - which
is what scripts/ci_check.sh passes, so warnings still gate CI without
hard-failing ad-hoc local runs.

The port of ``dcfm_tpu/analysis/rules.py``.  :data:`RULES` keeps every
id, family, severity and scope of the JAX package's registry.  Fifteen
rules (:data:`TRANSLATED`) detect the torch spelling of their hazard -
the global RNG stream, CUDA-graph captures, torch dtypes, rank branches,
non_blocking copies, torch allocations and matmuls, process groups,
live device counts - and carry summaries in the port's terms (and a new
name where the JAX name named a JAX thing); the other fifteen are the
JAX rules word for word, as their detectors are.  The trace rules
(:data:`TRACE_RULES`) keep the JAX ids DCFM1800-1808 in the port's terms
- an aten op graph recorded while an entry runs, not a jaxpr - and add
DCFM1809, which JAX's keyed randomness cannot need.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    family: str
    summary: str
    library_only: bool = False
    severity: str = "error"


RULES = {r.id: r for r in [
    # ---- DCFM0xx: linter meta-discipline -----------------------------
    Rule("DCFM002", "stale-suppression", "meta",
         "a `# dcfm: ignore[DCFMxxx]` pragma on a line where that rule "
         "no longer fires - the suppression has rotted (the code it "
         "excused was fixed, moved, or the pragma named the wrong "
         "rule) and now hides nothing but would hide a future "
         "regression; drop it",
         severity="warning"),
    # ---- DCFM1xx: RNG discipline -------------------------------------
    Rule("DCFM101", "rng-global-stream", "rng",
         "a variate drawn from the process-global stream - "
         "torch.randn/rand/randint/randperm/normal/poisson/bernoulli/"
         "multinomial, an in-place normal_/uniform_/exponential_, or a "
         "torch.distributions .sample() - with no generator= (or "
         "generator=None), or one seed expression handed to manual_seed "
         "twice on one path (two identical streams, or one replayed).  "
         "Draw from the caller's generator (noise.TorchNoise) and derive "
         "a distinct seed per stream (noise.stream_seed)"),
    Rule("DCFM102", "rng-inline-const-seed", "rng",
         "torch.manual_seed / Generator.manual_seed (or manual_seed_all) "
         "called with a constant seed in library code (fixed entropy; "
         "thread the caller's seed instead)",
         library_only=True),
    # ---- DCFM2xx: capture hygiene ------------------------------------
    Rule("DCFM201", "capture-host-sync", "jit",
         "host-synchronizing call (.item(), .tolist(), .cpu(), .numpy(), "
         "np.asarray/np.array of a tensor, float()/int()/bool() of a "
         "tensor, torch.cuda.synchronize, an event's .synchronize()/"
         ".query(), torch.nonzero/.nonzero()) inside a captured "
         "function: the body of a `with torch.cuda.graph(...)`, a "
         "callable given to torch.cuda.make_graphed_callables, the entry "
         "of a sweep_body trace builder, or anything they call"),
    Rule("DCFM202", "capture-python-control-flow", "jit",
         "Python if/while on a tensor inside a captured function (the "
         "truth test syncs, and the capture bakes in the branch it took "
         "for every replay; use torch.where or a mask)"),
    Rule("DCFM203", "capture-env-read", "jit",
         "os.environ read inside a captured function (baked in at "
         "capture time, ignored on every replay; read it outside the "
         "capture)"),
    # ---- DCFM3xx: dtype drift ----------------------------------------
    Rule("DCFM301", "dtype-float64", "dtype",
         "float64 dtype (torch.float64/torch.double outside a dtype "
         "guard, .double(), np.float64/'float64' passed to a torch call, "
         "or any float64 inside a captured function) leaking into the "
         "float32 device path"),
    Rule("DCFM302", "dtype-weak-float", "dtype",
         "builtin float used as a dtype in a torch call (dtype=float) or "
         ".to(float) (Python's float is float64; pin torch.float32)"),
    # ---- DCFM4xx: FFI safety -----------------------------------------
    Rule("DCFM401", "ffi-missing-signature", "ffi",
         "ctypes foreign function called without both argtypes and "
         "restype declared (mismatched implicit int signature corrupts "
         "the stack on 64-bit args)"),
    Rule("DCFM402", "ffi-pointer-from-temporary", "ffi",
         "ndarray.ctypes.data_as (or a wrapper around it) applied to a "
         "temporary expression - the array can be garbage-collected "
         "while the native call still holds its pointer; bind it to a "
         "local first"),
    Rule("DCFM403", "ffi-missing-contiguity-guard", "ffi",
         "array passed by pointer to a foreign call without a "
         "C-contiguity + dtype guard (np.ascontiguousarray / allocation "
         "/ .flags.c_contiguous check) in the same function"),
    # ---- DCFM5xx: thread-shutdown discipline -------------------------
    Rule("DCFM501", "thread-daemon-in-library", "thread",
         "threading.Thread(daemon=True) in library code: a daemon "
         "thread still inside native/numpy/JAX code at interpreter "
         "teardown aborts the process (SIGABRT); use a non-daemon "
         "thread joined before teardown",
         library_only=True),
    Rule("DCFM502", "thread-started-unjoinable", "thread",
         "Thread started as a temporary (threading.Thread(...).start()) "
         "or in a module with no .join() anywhere - nothing can join it "
         "before interpreter teardown"),
    Rule("DCFM503", "server-without-shutdown", "thread",
         "a socketserver/http.server lifecycle with no exit path: "
         "serve_forever() called in a module that never calls "
         ".shutdown(), or a ThreadingHTTPServer/TCPServer-style server "
         "constructed (outside a with-statement) in a module that never "
         "calls .server_close() - its worker threads and socket outlive "
         "teardown, the DCFM501 SIGABRT class"),
    # ---- DCFM6xx: robustness discipline ------------------------------
    Rule("DCFM601", "swallowed-exception", "robust",
         "a bare `except:` or `except Exception/BaseException` whose "
         "body neither re-raises, nor logs/warns, nor references the "
         "bound exception - the failure vanishes silently (the crash-"
         "recovery antipattern: resume/fallback code that eats the "
         "error it should surface).  Intentional swallows must carry "
         "an inline `# dcfm: ignore[DCFM601] - <why>`",
         library_only=True),
    Rule("DCFM602", "unverified-checkpoint-load", "robust",
         "a function reads raw checkpoint payload entries "
         "(np.load + a 'leaf_*' subscript) without any integrity "
         "verification call (utils.checkpoint._verify_crc / "
         "verify_checkpoint) in the same function - bytes from disk "
         "must be CRC-checked before a chain resumes on them",
         library_only=True),
    # ---- DCFM7xx: multi-host discipline ------------------------------
    Rule("DCFM701", "multihost-rank-branch-collective", "multihost",
         "a torch.distributed collective (all_reduce, all_gather, "
         "broadcast, gather, barrier, new_group, ...) or a RankMesh "
         "gather/reduce issued on one side of a branch on the rank "
         "(rank == 0, dist.get_rank(), process_id) that the other side "
         "never issues - an if with no matching collective in its else, "
         "or an early return on the rank before one.  The ranks that "
         "take the other side never join it and the group deadlocks, in "
         "exactly the pod regime the code targets.  Issue it on every "
         "rank (None / an empty buffer where a rank has nothing to "
         "give)",
         library_only=True),
    # ---- DCFM9xx: telemetry discipline -------------------------------
    Rule("DCFM901", "print-bypasses-telemetry", "obs",
         "bare print() (no file=, or file=sys.stdout/sys.stderr) or "
         "sys.stdout/sys.stderr.write() in a dcfm_tpu library module - "
         "ad-hoc console output is invisible to the flight recorder "
         "and unscrapable by metrics; emit through dcfm_tpu.obs "
         "(recorder.record / a registry metric) instead.  CLI entry "
         "modules (cli.py, __main__.py) are exempt, print(..., "
         "file=<handle parameter>) is parameterized output and fine, "
         "and deliberate console protocol lines carry an inline "
         "`# dcfm: ignore[DCFM901] - <why>`",
         library_only=True),
    # ---- DCFM8xx: runtime pipeline discipline ------------------------
    Rule("DCFM801", "pipeline-blocking-host-fetch", "pipeline",
         "blocking host fetch (.cpu(), .item(), .tolist(), .numpy(), "
         "torch.cuda.synchronize(), or np.asarray/np.array on a name) "
         "inside a function of a runtime pipeline module (any module "
         "under - or named - 'runtime', such as dcfm_tpu_torch/runtime/) "
         "with no PRECEDING non_blocking=True copy or event record in "
         "the same function.  The chunk pipeline's contract is "
         "async-first: dispatch the device->host copy at the chunk "
         "boundary and drain off-thread "
         "(runtime/pipeline.StreamingFetcher), so a synchronous fetch "
         "silently serializes the chain behind the link.  Deliberate "
         "sync fetches (KB-sized trace rows, the drain half of an "
         "already-dispatched async) must carry an inline "
         "`# dcfm-torch: ignore[DCFM801] - <why>`",
         library_only=True),
    # ---- DCFM10xx: serving discipline --------------------------------
    Rule("DCFM1001", "handler-unbounded-blocking-wait", "serve",
         "an HTTP/socketserver handler route method (do_GET/do_POST/"
         "handle of a BaseHTTPRequestHandler/StreamRequestHandler "
         "subclass) performs a blocking wait with no bound: .join() or "
         "queue .get() with no timeout, or a socket operation "
         "(recv/accept/connect) on a socket the method created without "
         "settimeout.  One slow client then parks the handler thread "
         "forever - the slow-loris hang class; every wait in a request "
         "path must be deadline-bounded",
         library_only=True),
    # ---- DCFM11xx: lockset race discipline ---------------------------
    Rule("DCFM1101", "lockset-inconsistent-guard", "locks",
         "an instance attribute of a multi-threaded class (one that "
         "runs its own methods on threading.Thread targets, is a "
         "handler class, or owns a lock) is written under a guarding "
         "lock on one path and read/written without it on another - "
         "the lockset intersection over its access sites is empty, the "
         "Eraser-style data-race signature.  Hold the same lock on "
         "every access, or annotate the documented benign race "
         "(immutable-reference hot-swap, monotonic gauge) with "
         "`# dcfm: ignore[DCFM1101] - <why>`",
         library_only=True),
    Rule("DCFM1102", "lock-order-inversion", "locks",
         "two locks are acquired in both nesting orders somewhere in "
         "this module (A held while taking B, and B held while taking "
         "A) - the classic ABBA deadlock; pick one global order and "
         "acquire in that order everywhere",
         library_only=True),
    # ---- DCFM13xx: daemon poll-loop discipline -----------------------
    Rule("DCFM1301", "poll-loop-without-shutdown-check", "daemon",
         "a constant-condition polling loop (while True/while 1) that "
         "paces itself with time.sleep() but consults no shutdown "
         "signal: no break, no return, and no Event .wait()/.is_set() "
         "anywhere in its body.  The loop can only be stopped by "
         "killing its thread or process - SIGTERM drains nothing, "
         "tests leak the thread, and at interpreter teardown it joins "
         "the DCFM501 SIGABRT class.  Pace with stop.wait(interval) "
         "and gate each turn on stop.is_set() (the watch daemon's "
         "idiom), or give the loop an exit path",
         library_only=True),
    # ---- DCFM12xx: host-buffer lifetime discipline -------------------
    Rule("DCFM1201", "host-buffer-lifetime", "lifetime",
         "a host buffer of numpy provenance (np.load / np.memmap / a "
         "view of one / a loader-helper return) reaches "
         "torch.from_numpy/torch.as_tensor (a zero-copy alias) and then "
         "an asynchronous device copy (.to(dev, non_blocking=True), "
         ".copy_(..., non_blocking=True), .cuda(non_blocking=True), "
         ".pin_memory()), or outlives the with-block of its source, "
         "without an owned-copy commit - if the source dies before the "
         "card reads it this is a use-after-free (the JAX package's "
         "PR-1 resume SIGSEGV / PR-5 multiproc NaN-Sigma / PR-6 "
         "stream-drain class).  Commit through .clone() / np.array / "
         "torch.tensor while the source is still alive",
         library_only=True),
    # ---- DCFM15xx: scale-out discipline ------------------------------
    Rule("DCFM1501", "dense-quadratic-materialization", "scale",
         "a host or device allocation (np/torch zeros/empty/ones/full, "
         "a tensor's new_zeros/new_empty) whose shape repeats the same "
         "symbolic dimension - an O(d^2) dense "
         "buffer such as (p, p) or (n_pairs, P, P) with a repeated "
         "panel axis.  At the scale-out shapes the streaming ingest "
         "targets (p >= 1e6) a quadratic host buffer is hundreds of GB, "
         "so library code must route through the packed-panel / "
         "sigma_block / artifact seams instead of densifying.  The few "
         "sanctioned assembly sites (the materialize_sigma='always' "
         "path, force=True restores) carry an inline "
         "`# dcfm: ignore[DCFM1501] - <why>`",
         library_only=True),
    # ---- DCFM14xx: chain-axis reduction discipline -------------------
    Rule("DCFM1401", "chain-axis-silent-reduction", "chains",
         "a host-side reduction (np/torch mean/sum or .mean()/.sum()) "
         "over a chain-major array (a name containing 'chain') "
         "collapses the leading chain axis implicitly - a bare 0 as "
         "axis=, dim= or the positional axis, or no axis at all.  Trace blocks, pooled Sigma, and draws are "
         "ALWAYS chain-major (a single-chain run carries a length-1 "
         "leading axis), so an ad-hoc axis-0 mean silently conflates "
         "'average over chains' with 'average over draws' and breaks "
         "the moment num_chains changes.  Pool through the named seam "
         "(runtime.fetch.pool_chains / utils.estimate._pool_chain_axis) "
         "or put 'chain' in the reducing helper's own name so the "
         "intent is explicit",
         library_only=True),
    # ---- DCFM16xx: mixed-precision discipline ------------------------
    Rule("DCFM1601", "precision-unsafe-matmul", "precision",
         "a torch.mm/bmm/matmul/einsum/baddbmm/addmm call (or the "
         "method, or `@`) takes an operand cast to bfloat16/float16 "
         "(`.to(torch.bfloat16)`, `.bfloat16()`, `.half()`, "
         "`dtype=torch.float16`) without `out_dtype=torch.float32` - "
         "the product is then returned, and rounded, in the low input "
         "precision, which is how the mixed-precision sweep silently "
         "loses the accuracy contract (README 'Precision policy').  "
         "Route low-precision products through "
         "models/conditionals.mm_bf16 (out_dtype=torch.float32 on the "
         "card, the float32 upcast of the rounded inputs elsewhere)",
         library_only=True),
    # ---- DCFM17xx: partition-rule conformance ------------------------
    Rule("DCFM1701", "inline-process-group", "partition",
         "torch.distributed.new_group/init_process_group (or a device "
         "mesh) or a RankLayout(...) built outside parallel/ - the rank "
         "layout (parallel/mesh.make_layout / make_pod_layout), the "
         "process groups (parallel/shard.RankMesh) and the rendezvous "
         "(parallel/multihost.initialize) live in one package so a "
         "placement change edits ONE place and the trace gate can audit "
         "every group.  Sanctioned one-off constructions carry an inline "
         "`# dcfm-torch: ignore[DCFM1701] - <why>`",
         library_only=True),
    # ---- DCFM19xx: promotion-pointer discipline ----------------------
    Rule("DCFM1901", "pointer-mutation-outside-promote", "pointer",
         "an os.replace/os.link call whose target names a CURRENT "
         "promotion pointer, outside serve/promote.py - the pointer "
         "compare-and-swap (verify, monotonic generation, atomic "
         "replace, audit hardlink, promotion event) lives in exactly "
         "one function; a second writer can re-number history or flip "
         "the fleet to an unverified artifact without a recorded "
         "promotion.  Route pointer moves through promote_artifact / "
         "promote_delta; a sanctioned exception carries an inline "
         "`# dcfm: ignore[DCFM1901] - <why>`",
         library_only=True),
    # ---- DCFM20xx: elastic-resume topology discipline ----------------
    Rule("DCFM2001", "topology-constant-in-resume-path", "topology",
         "a live topology query (torch.cuda.device_count / "
         "dist.get_world_size / len(...ranks)) feeding carry-shape or "
         "window-divisor "
         "arithmetic inside a resume/checkpoint-path function - "
         "elastic resume restarts a checkpoint on a DIFFERENT capacity "
         "than the one that saved it, so shape and divisor bookkeeping "
         "must flow from the checkpoint's recorded meta (topology / "
         "chain_acc_starts / fold_draws).  Recording the live capacity "
         "INTO that meta, comparing it in a gate, or naming a "
         "per-process file with it is the sanctioned direction; a "
         "deliberate exception carries an inline "
         "`# dcfm-torch: ignore[DCFM2001] - <why>`",
         library_only=True),
]}

# The rules whose detectors match the torch spelling of their hazard;
# the other RULES are the JAX package's, detector and text alike.
TRANSLATED = frozenset({
    "DCFM101", "DCFM102", "DCFM201", "DCFM202", "DCFM203", "DCFM301",
    "DCFM302", "DCFM701", "DCFM801", "DCFM1201", "DCFM1401", "DCFM1501",
    "DCFM1601", "DCFM1701", "DCFM2001"})


# Trace-level rules (analysis/tracecheck.py): verified on the aten ops a
# registered entry dispatches while it runs once under a recording
# TorchDispatchMode, not on source text, so they live in their own
# registry - the AST fixture tests assert that every RULES entry has a
# source-level firing fixture, which trace rules cannot have.  The CLI
# merges both registries for --list-rules/--rules-md/SARIF metadata, and
# baseline fingerprinting treats the two identically (trace findings
# anchor at the entry's registration line).
TRACE_RULES = {r.id: r for r in [
    Rule("DCFM1800", "trace-entry-error", "trace",
         "a registered trace entry failed to build or to run once under "
         "the recorder - the gate cannot verify its invariants at all, "
         "which is itself a gate failure (an entry that stops running "
         "on representative tensors has usually grown a dependence on "
         "something the trip cannot hold)"),
    Rule("DCFM1801", "collective-unknown-group", "trace",
         "a collective issued through the mesh's seam "
         "(RankMesh.reduce_fn / gather_fn) names a process group other "
         "than the rank's chain row (RankLayout.row_ranks(row)) - a "
         "group the mesh never made, or one of other ranks; the sweep's "
         "sums and gathers then run over the wrong shards"),
    Rule("DCFM1802", "collective-spans-chains", "trace",
         "a collective inside a sweep-body entry names a group that "
         "spans chain rows (a column group, or the whole world of a "
         "packed chains x shards layout) - chains never communicate "
         "during the sweep, so packed-mesh results stay chain-for-chain "
         "identical to one-device runs"),
    Rule("DCFM1803", "dtype-leak", "trace",
         "a float64 tensor anywhere in an entry, or a bfloat16 tensor in "
         "an entry registered under the f32 defaults - the "
         "compute_dtype default must run the pre-knob float32 program "
         "exactly, and nothing of the chain is float64"),
    Rule("DCFM1804", "lowprec-accum-unpinned", "trace",
         "a matmul-family op (mm/bmm/addmm/baddbmm/matmul) in a bf16 "
         "entry outputs bfloat16 or float16 - the product then rounds "
         "its output to the low precision, voiding the mixed-precision "
         "contract that models/conditionals.mm_bf16 keeps with "
         "out_dtype=torch.float32"),
    Rule("DCFM1805", "host-sync-in-trip", "trace",
         "a host synchronization inside a trip: _local_scalar_dense / "
         "item, a copy from a device tensor to a CPU tensor, or an op "
         "whose output shape depends on the data (nonzero, "
         "masked_select, unique) - each stalls the host on the card "
         "and cannot be captured into a CUDA graph"),
    Rule("DCFM1806", "carry-not-in-place", "trace",
         "a declared carry tensor of an entry does not keep its storage "
         "(data_ptr) across the entry - the CUDA graphs replay into "
         "the static carry in place, so a carry rebound to a new tensor "
         "is a state the next replay never reads"),
    Rule("DCFM1807", "unstable-trace-key", "trace",
         "an entry's static key embeds unhashable or identity-hashed "
         "mutable Python state (a list/dict/set/ndarray, or an object "
         "hashing by id) - every lookup of a graph or a build keyed on "
         "it then misses or falsely hits; key on frozen config "
         "dataclasses, shapes, and layout signatures only"),
    Rule("DCFM1808", "collective-spans-hosts", "trace",
         "a collective inside a sweep-body entry of a pod layout "
         "(parallel/mesh.make_pod_layout) names one host's part of the "
         "chain row instead of the whole row - the only sanctioned "
         "cross-host collectives are the X update's sums and the "
         "conquer's gathers over the full row; a per-host collective "
         "mixes partial state and breaks the pod's bitwise equality "
         "with the one-process mesh"),
    Rule("DCFM1809", "variate-in-trip", "trace",
         "a variate drawn (a random aten op: normal_, uniform_, "
         "exponential_, randn, _standard_gamma, ...) or a CUDA event "
         "recorded or waited on by the capturing thread inside a "
         "sweep-body entry - a draw inside a CUDA graph replays the same "
         "Philox offsets on every replay, and an event inside a capture "
         "invalidates it; draw outside the trip (noise.draw_into) and "
         "hand the sweep BufferedDraws"),
]}


# Merged view for CLI listing, README generation and SARIF metadata.
ALL_RULES = {**RULES, **TRACE_RULES}
