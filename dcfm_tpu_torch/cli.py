"""Command-line interface of the PyTorch port: fit, export, serve, promote.

The port's copy of ``dcfm_tpu/cli.py`` (the same subcommands and flags),
installed as ``dcfm-tpu-torch``:

    python -m dcfm_tpu_torch.cli fit Y.npy --shards 8 --factors 40 \\
        --burnin 1000 --mcmc 1000 --thin 5 --rho 0.9 --out sigma.npy
    python -m dcfm_tpu_torch.cli export Y.npy --from-checkpoint ck.npz -o art
    python -m dcfm_tpu_torch.cli serve art --port 0           # on the card
    python -m dcfm_tpu_torch.cli promote root root/v2 [--delta]
    python -m dcfm_tpu_torch.cli delta root/v2 --base root --out v2.delta
    python -m dcfm_tpu_torch.cli events run_dir

``fit`` runs on the card unless ``--backend torch_cpu``; ``serve`` and
``export`` take ``--device`` (default ``cuda``).  What the port does not
run is refused by name: ``fit --supervise``, ``supervise`` and ``watch``
(ROADMAP Queue A item 7), a mesh or a multi-process rendezvous (item 4,
as ``config.validate`` refuses it), and ``lint`` / ``test-isolated``,
which analyse the JAX package and belong to its CLI.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

# the JAX CLI's multi-process rendezvous variables
_MULTIPROCESS_ENV = ("DCFM_COORDINATOR", "DCFM_NUM_PROCESSES",
                     "DCFM_PROCESS_ID")
_SUPERVISOR = ("is not ported to dcfm_tpu_torch yet: ROADMAP Queue A "
               "item 7 (the supervisor and the online loop)")


def _load(path: str, *, sparse: bool = False, mmap: bool = False):
    """Input data: a .npy (memmapped under ``mmap``: fit streams it), a
    .csv, or under ``sparse`` a scipy ``save_npz`` file, read without
    scipy as a :class:`~dcfm_tpu_torch.utils.preprocess.SparseMatrix`
    (csr or csc) that stays sparse through fit."""
    from dcfm_tpu_torch.utils.preprocess import SparseMatrix
    if sparse:
        if not path.endswith(".npz"):
            raise SystemExit(
                f"--sparse expects a scipy.sparse .npz file, got {path}")
        with np.load(path) as z:
            fmt = bytes(np.asarray(z["format"]).item()).decode() \
                if "format" in z.files else ""
            if fmt not in ("csr", "csc"):
                raise SystemExit(
                    f"{path}: sparse format {fmt!r} is not csr or csc "
                    "(scipy.sparse.save_npz of a csr_matrix / csc_matrix)")
            return SparseMatrix(indptr=z["indptr"], indices=z["indices"],
                                data=z["data"],
                                shape=tuple(int(d) for d in z["shape"]),
                                format=fmt)
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r" if mmap else None)
    if path.endswith(".csv"):
        return np.loadtxt(path, delimiter=",")
    raise SystemExit(f"unsupported input format: {path} (use .npy or .csv)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dcfm-tpu-torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    # HELP-ONLY entries: main() dispatches them before argparse runs (the
    # events reader's flags belong to its own parser; the others are
    # refusals), so `--help` lists every subcommand of the JAX CLI
    sub.add_parser(
        "lint", add_help=False,
        help="not in this CLI: the static analysis reads the JAX package "
             "(python -m dcfm_tpu.cli lint)")
    sub.add_parser(
        "test-isolated", add_help=False,
        help="not in this CLI: the per-file test runner belongs to the "
             "JAX package (python -m dcfm_tpu.cli test-isolated)")
    sub.add_parser(
        "supervise", add_help=False,
        help="the crash supervisor - not ported yet (refused)")
    sub.add_parser(
        "events", add_help=False,
        help="summarize a run's flight-recorder event log "
             "(FitResult.events_path / <checkpoint>.obs): launches, "
             "deaths, promoted generations, resume decisions, rewinds, "
             "injected faults, per-phase walls, stream overlap, online "
             "watch cycles; --trace exports a Chrome/Perfetto trace; "
             "see `dcfm-tpu-torch events --help`")
    sub.add_parser(
        "watch", add_help=False,
        help="the online fit->serve daemon - not ported yet (refused)")

    # Posterior-serving subsystem (dcfm_tpu_torch/serve): export a
    # completed fit to a memory-mapped artifact, then serve
    # entry/block/interval queries over HTTP from the card.
    e = sub.add_parser(
        "export", help="export a posterior to a servable memmap artifact "
        "(from a fresh fit, or from an existing v6 checkpoint - no refit)")
    e.add_argument("data", help="observations, (n, p) .npy or .csv (for "
                   "--from-checkpoint this is the SAME data the "
                   "checkpointed chain ran on; the fingerprint is checked)")
    e.add_argument("--out", "-o", required=True,
                   help="artifact directory to write")
    e.add_argument("--from-checkpoint", default=None, metavar="PATH",
                   help="export from this v6 checkpoint (plain file or "
                        ".procK-of-N set) instead of running a fit")
    e.add_argument("--shards", "-g", type=int, default=0,
                   help="feature shards g (fit-and-export mode)")
    e.add_argument("--factors", "-k", type=int, default=0,
                   help="TOTAL latent factors k (fit-and-export mode)")
    e.add_argument("--burnin", type=int, default=1000)
    e.add_argument("--mcmc", type=int, default=1000)
    e.add_argument("--thin", type=int, default=1)
    e.add_argument("--rho", type=float, default=0.9)
    e.add_argument("--prior", default="mgp",
                   choices=["mgp", "horseshoe", "dl"])
    e.add_argument("--posterior-sd", action="store_true",
                   help="also accumulate + export entrywise posterior-SD "
                        "panels (enables /v1/interval on the server)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--device", default="cuda",
                   help="device of the fit-and-export mode's fit (cuda, "
                        "cuda:N, cpu)")

    s = sub.add_parser(
        "serve", help="serve a posterior artifact over HTTP "
        "(/v1/entry /v1/block /v1/interval /healthz /metrics); "
        "drains gracefully on SIGTERM")
    s.add_argument("artifact", help="artifact directory (dcfm-tpu-torch export)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080,
                   help="TCP port; 0 picks a free port (printed on stdout)")
    s.add_argument("--cache-mb", type=int, default=256,
                   help="byte budget of the dequantized-panel LRU cache")
    s.add_argument("--max-queue", type=int, default=1024,
                   help="bounded entry-query queue; a full queue rejects "
                        "with 429 + retry (backpressure, never unbounded "
                        "growth)")
    s.add_argument("--max-batch", type=int, default=256,
                   help="max entry queries coalesced into one batch")
    s.add_argument("--request-timeout", type=float, default=2.0,
                   help="per-request deadline (seconds); queued requests "
                        "past it fail 504 instead of being served late")
    s.add_argument("--io-timeout", type=float, default=10.0,
                   help="per-connection socket read/write timeout "
                        "(seconds); bounds how long a slow-loris client "
                        "can park a handler thread")
    s.add_argument("--workers", type=int, default=1,
                   help="run N supervised SO_REUSEPORT worker processes "
                        "sharing the port (dead workers respawn with "
                        "backoff; repeated instant deaths trip poison "
                        "detection; SIGTERM drains the whole fleet)")
    s.add_argument("--run-dir", default=None,
                   help="fleet run directory (flight-recorder events, "
                        "fleet.json liveness, worker logs); default "
                        "$DCFM_OBS_DIR or a fresh temp dir")
    s.add_argument("--swap-poll", type=float, default=0.5,
                   help="seconds between promotion-pointer probes when "
                        "the artifact path is a promotion root (a dir "
                        "with a CURRENT pointer); SIGHUP forces a probe")
    s.add_argument("--shed-high", type=float, default=0.75,
                   help="batcher queue fill at which the expensive "
                        "routes (/v1/block, /v1/interval) start "
                        "shedding with typed 503 + Retry-After")
    s.add_argument("--shed-low", type=float, default=0.50,
                   help="queue fill at which shedding stops (hysteresis)")
    s.add_argument("--swap-adopt", choices=("auto", "off"), default="auto",
                   help="hot-swap memmap adoption: 'auto' serves pairs "
                        "the CRC tables prove unchanged from the OLD "
                        "epoch's memmaps (re-warm cost scales with "
                        "changed panels, not p^2), 'off' re-opens every "
                        "panel from the new artifact")
    s.add_argument("--fleet-backoff", type=float, default=0.5,
                   help="base respawn backoff after an instant worker "
                        "death (doubles per consecutive instant death)")
    s.add_argument("--fleet-min-uptime", type=float, default=1.0,
                   help="a worker dying faster than this counts as an "
                        "instant death (poison candidate)")
    s.add_argument("--fleet-poison-deaths", type=int, default=3,
                   help="consecutive instant deaths of one worker that "
                        "abort the fleet with a typed poison error")
    s.add_argument("--fleet-grace", type=float, default=30.0,
                   help="seconds SIGTERM'd workers get to drain before "
                        "being reaped")
    s.add_argument("--fleet-watchdog", type=float, default=0.0,
                   help="hard bound on fleet lifetime in seconds "
                        "(0 = unbounded); the chaos harness's no-hang "
                        "guarantee")
    s.add_argument("--reuse-port", action="store_true",
                   help="bind with SO_REUSEPORT (set automatically for "
                        "fleet workers)")
    s.add_argument("--worker-index", type=int, default=None,
                   help=argparse.SUPPRESS)
    s.add_argument("--device", default="cuda",
                   help="device that holds the dequantized-panel cache and "
                        "answers the queries (cuda, cuda:N, cpu); every "
                        "fleet worker opens its own context on it")

    pr = sub.add_parser(
        "promote", help="atomically publish an artifact to a live serving "
        "fleet: CRC-verify the candidate, then replace the root's "
        "CURRENT pointer (generation monotonic; workers hot-swap with "
        "zero dropped requests)")
    pr.add_argument("root", help="promotion root the fleet serves "
                    "(`dcfm-tpu-torch serve ROOT`)")
    pr.add_argument("candidate", help="candidate artifact directory "
                    "(inside or resolvable from the root)")
    pr.add_argument("--no-verify", action="store_true",
                    help="skip the full per-panel CRC sweep (workers "
                         "still refuse a corrupt candidate at swap time)")
    pr.add_argument("--delta", action="store_true",
                    help="CANDIDATE is a delta directory (dcfm-tpu-torch "
                         "delta): materialize it against the artifact "
                         "CURRENT names, then promote the byte-identical "
                         "reconstruction through the same "
                         "compare-and-swap")
    pr.add_argument("--expect-generation", type=int, default=None,
                    help="refuse unless the promotion would write "
                         "exactly this generation (the online loop's "
                         "monotonicity gate)")

    d = sub.add_parser(
        "delta", help="encode a candidate artifact as a per-panel delta "
        "against a base generation (only changed panel bytes ship; "
        "maps + meta travel verbatim), or --apply one back into a "
        "byte-identical full artifact")
    d.add_argument("candidate", help="candidate artifact directory "
                   "(with --apply: the delta directory)")
    d.add_argument("--base", required=True,
                   help="base artifact directory, or a promotion root "
                        "(its CURRENT target is used)")
    d.add_argument("--out", required=True,
                   help="output directory (the delta; with --apply: the "
                        "reconstructed full artifact)")
    d.add_argument("--apply", action="store_true",
                   help="materialize CANDIDATE (a delta) against --base "
                        "into a full artifact, CRC-verified "
                        "byte-identical to the original candidate")

    f = sub.add_parser("fit", help="fit the model and write Sigma-hat")
    f.add_argument("data", help="observations, (n, p) .npy or .csv")
    f.add_argument("--shards", "-g", type=int, required=True,
                   help="number of feature shards (g)")
    f.add_argument("--factors", "-k", type=int, required=True,
                   help="TOTAL latent factors k; each shard gets k/g")
    f.add_argument("--burnin", type=int, default=1000)
    f.add_argument("--mcmc", type=int, default=1000)
    f.add_argument("--thin", type=int, default=1)
    f.add_argument("--rho", type=float, default=0.9,
                   help="cross-shard factor correlation in [0, 1]")
    f.add_argument("--prior", default="mgp",
                   choices=["mgp", "horseshoe", "dl"])
    f.add_argument("--estimator", default="scaled",
                   choices=["scaled", "plain"])
    f.add_argument("--rank-adapt", action="store_true",
                   help="adaptively truncate redundant loading columns "
                        "during burn-in (Bhattacharya-Dunson adaptation)")
    f.add_argument("--posterior-sd", action="store_true",
                   help="also write entrywise posterior standard deviations "
                        "to <out>_sd.npy (second-moment accumulation)")
    f.add_argument("--chains", type=int, default=1,
                   help="independent MCMC chains; > 1 enables split-R-hat "
                        "in the report and pools the covariance estimate "
                        "over chains.  On a mesh run whose device count "
                        "divides evenly the chains become a 2-D mesh axis "
                        "(chain rows x shard columns) with per-row "
                        "collectives - same chains, smaller collective "
                        "groups")
    f.add_argument("--early-stop", default="off", choices=["off", "rhat"],
                   help="'rhat': stop at the first chunk boundary where "
                        "every trace summary's split-R-hat < threshold AND "
                        "its pooled ESS >= target (needs --chains >= 2); "
                        "'off' runs the full schedule, bit-identical to a "
                        "build without the feature")
    f.add_argument("--rhat-threshold", type=float, default=1.01,
                   help="early-stop R-hat threshold (Vehtari et al. 2021 "
                        "recommend 1.01)")
    f.add_argument("--ess-target", type=float, default=400.0,
                   help="early-stop pooled effective-sample-size target")
    f.add_argument("--seed", type=int, default=0)
    f.add_argument("--sparse", action="store_true",
                   help="input is a scipy-format sparse .npz "
                        "(scipy.sparse.save_npz).  The matrix is ingested "
                        "by the streaming preprocess - the dense (n, p) "
                        "matrix never materializes on the host - and the "
                        "fit defaults to the lazy posterior (no dense "
                        "Sigma .npy; see --materialize-sigma)")
    f.add_argument("--mmap", action="store_true",
                   help="open a .npy input memory-mapped (out-of-core): "
                        "preprocess streams columns from disk instead of "
                        "loading the whole matrix")
    f.add_argument("--materialize-sigma", default="auto",
                   choices=["auto", "always", "never"],
                   help="whether fit assembles the dense (p, p) posterior "
                        "mean.  'auto' materializes for dense inputs up "
                        "to 100k used columns and keeps sparse/mmap fits "
                        "lazy; 'never' skips the quadratic assembly (no "
                        "Sigma .npy is written - export an artifact "
                        "instead); 'always' forces the dense matrix "
                        "regardless of input")
    f.add_argument("--no-permute", action="store_true",
                   help="shard features in their given order instead of the "
                        "reference's random permutation.  When features have "
                        "local structure (e.g. gene modules in contiguous "
                        "blocks) this keeps each module inside one shard and "
                        "measurably beats the permuted fit (0.171 vs 0.30 "
                        "rel err on the gene-expression benchmark, beating "
                        "even the sample covariance at 0.178 - see README "
                        "'Accuracy vs the trivial baseline')")
    f.add_argument("--x-prior-precision", type=float, default=1.0,
                   help="prior precision multiplier on the shared factor X; "
                        "1.0 is the model-implied value, g reproduces the "
                        "reference's g*eye(K) (quirk Q3)")
    f.add_argument("--backend", default="auto",
                   choices=["auto", "torch_cuda", "torch_cpu"],
                   help="'auto' and 'torch_cuda' fit on the card, "
                        "'torch_cpu' on the host")
    f.add_argument("--mesh-devices", type=int, default=0,
                   help="devices for the shard mesh axis; 0 = single device")
    f.add_argument("--fetch-dtype", default="float32",
                   choices=["float32", "bfloat16", "float16", "quant8"],
                   help="dtype the covariance panels cross the device->host "
                        "link in; 'quant8' (int8 + per-panel scale) quarters "
                        "the dominant transfer of a big fit at ~4e-3-of-"
                        "panel-max rounding, far below Monte Carlo error")
    f.add_argument("--upload-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"],
                   help="dtype Y crosses the host->device link in (compute "
                        "is always float32)")
    f.add_argument("--combine-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="input dtype of the combine-step block matmuls; "
                        "bfloat16 feeds the tensor cores with float32 "
                        "accumulation")
    f.add_argument("--compute-dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="input dtype of the LARGE Gibbs-sweep matmuls "
                        "(Z/X/Lambda updates and the covariance-panel "
                        "accumulation).  'bf16' feeds them to the tensor "
                        "cores with float32 accumulation; all chain "
                        "state, RNG draws, and every K x K factorization "
                        "stay float32 (see README 'Precision policy').  "
                        "'f32' (default) compiles graphs bitwise-identical "
                        "to a build without the knob")
    f.add_argument("--sse-mode", default="resid",
                   choices=["resid", "gram", "auto"],
                   help="psi-stage SSE strategy.  'gram' computes the "
                        "per-feature SSE from the Lambda stage's eta'eta / "
                        "eta'Y cross-moments instead of the (n, P) residual "
                        "and draws the residual precisions rejection-free - "
                        "measured 3.4x on the whole sweep at the bench "
                        "shape (see README 'Breaking the psi wall').  "
                        "'auto' picks 'gram' when n >= K per shard.  "
                        "'resid' (default) compiles graphs bitwise-"
                        "identical to a build without the knob")
    f.add_argument("--combine-chunks", type=int, default=1,
                   help="split each saved draw's combine into this many "
                        "column chunks with a cross-shard rendezvous between "
                        "them (pod-scale determinism on timeshared meshes); "
                        "must divide --shards")
    f.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="write a torch.profiler (Chrome/Perfetto) trace "
                        "here; per-conditional ranges mark the phases")
    f.add_argument("--chunk-size", type=int, default=0,
                   help="Gibbs iterations per chunk; 0 = whole run")
    f.add_argument("--out", "-o", default="sigma.npy",
                   help="output .npy for the covariance estimate")
    f.add_argument("--raw-coords", action="store_true",
                   help="skip de-standardization (correlation-scale output)")
    f.add_argument("--imputed-out", default=None, metavar="PATH",
                   help="when Y has NaN entries (imputed each sweep by "
                        "Gibbs data augmentation), also write the "
                        "posterior-mean completed (n, p) matrix here "
                        "(.npy; observed entries pass through exactly)")
    f.add_argument("--draws-out", default=None, metavar="PATH",
                   help="also retain every thinned post-burn-in draw of "
                        "(Lambda, ps, X) and write them to this .npz "
                        "(shard coordinates; costs num_saved x state-size "
                        "device memory)")
    f.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write the chain state here at every chunk boundary "
                        "(--chunk-size is the cadence)")
    f.add_argument("--checkpoint-every", default="auto", metavar="K",
                   type=lambda v: v if v == "auto" else int(v),
                   help="save every K-th chunk boundary (the final chunk "
                        "always saves).  Default 'auto' measures the first "
                        "save's drain and sizes K so one save's hidden "
                        "write fits inside the compute it overlaps")
    f.add_argument("--checkpoint-mode", default="full",
                   choices=("full", "light"),
                   help="'light' = state-only saves (MBs instead of the "
                        "p^2-sized snapshot; viable on a slow link).  A "
                        "light resume restores the chain exactly but "
                        "restarts covariance accumulation at the "
                        "checkpointed iteration")
    f.add_argument("--checkpoint-full-every", type=int, default=0,
                   metavar="N",
                   help="in light mode, upgrade every N-th due save to a "
                        "full snapshot (bounds the draws a crash loses); "
                        "0 = never")
    f.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint when one exists - a "
                        "plain file or a multi-process .procK-of-N set, "
                        "resharded if the topology changed - starting "
                        "fresh only when NONE exists; an existing but "
                        "incompatible checkpoint is a hard refusal, never "
                        "a silent restart (a same-topology resumed chain "
                        "is bitwise-identical to an uninterrupted one)")
    f.add_argument("--elastic", dest="elastic", action="store_const",
                   const=True, default="auto",
                   help="always allow elastic adoption: a checkpoint "
                        "written on a different chain count resumes onto "
                        "--chains (surviving chains continue bitwise, "
                        "dropped chains' draws fold into the pooled "
                        "estimate, new chains birth on fresh RNG "
                        "lineages).  The default ('auto') allows the "
                        "same unless DCFM_NO_ELASTIC=1 is set")
    f.add_argument("--no-elastic", dest="elastic", action="store_const",
                   const=False,
                   help="refuse (typed) a checkpoint whose chain count "
                        "differs from --chains instead of adopting it")
    f.add_argument("--keep-last", type=int, default=1, metavar="K",
                   help="retain K checkpoint generations (the live file "
                        "plus K-1 rotated .bakN predecessors); >= 2 lets "
                        "a CRC-corrupt newest checkpoint fall back to the "
                        "previous one instead of restarting from zero")
    f.add_argument("--sentinel", default="auto",
                   choices=("auto", "off", "abort", "rewind"),
                   help="divergence sentinel policy on NaN/Inf in the "
                        "chain: rewind to the last checkpoint with a "
                        "re-lineaged RNG key and escalated ridge jitter, "
                        "abort with a typed error, or off (pre-sentinel "
                        "behavior: garbage runs to completion).  auto = "
                        "rewind when checkpointing, abort otherwise")
    f.add_argument("--supervise", action="store_true",
                   help="run the fit in a supervised child process: on "
                        "crash/SIGKILL/preemption it resumes from the "
                        "last good checkpoint with exponential backoff; "
                        "a CRC-corrupt checkpoint falls back to the "
                        "previous retained one (--keep-last >= 2); the "
                        "same iteration killing the child twice aborts "
                        "with a typed poison report.  Requires "
                        "--checkpoint")
    f.add_argument("--supervise-max-retries", type=int, default=5,
                   metavar="N", help="relaunch budget under --supervise")
    f.add_argument("--supervise-backoff", type=float, default=1.0,
                   metavar="S",
                   help="base of the exponential relaunch backoff "
                        "(seconds) under --supervise")
    f.add_argument("--supervise-poison-deaths", type=int, default=2,
                   metavar="N",
                   help="consecutive same-iteration no-progress deaths "
                        "that count as a poisoned run under --supervise "
                        "(raise on heavily-preempted fleets, or for "
                        "chaos plans that kill more than one launch)")
    f.add_argument("--supervise-watchdog", type=float, default=0.0,
                   metavar="S",
                   help="deadlock watchdog under --supervise: abort "
                        "with a typed PodHangError if the child "
                        "neither finishes nor dies within S seconds "
                        "of its launch (0 = off)")
    return p


def _refused(raw: list) -> str:
    """The refusal message of a command line the port does not run, or
    an empty string."""
    cmd = raw[0] if raw else ""
    if cmd in ("lint", "test-isolated"):
        return (f"`{cmd}` analyses the JAX package and is not part of "
                f"this CLI: run `python -m dcfm_tpu.cli {cmd}`")
    if cmd in ("supervise", "watch"):
        return f"`{cmd}` {_SUPERVISOR}"
    if cmd == "fit" and "--supervise" in raw:
        return f"`fit --supervise` {_SUPERVISOR}"
    if cmd == "fit" and any(os.environ.get(k) for k in _MULTIPROCESS_ENV):
        return ("a multi-process fit (DCFM_COORDINATOR / "
                "DCFM_NUM_PROCESSES / DCFM_PROCESS_ID) is not ported to "
                "dcfm_tpu_torch yet: ROADMAP Queue A item 4 (multi-GPU "
                "shards)")
    return ""


def main(argv=None) -> int:
    raw = list(sys.argv[1:] if argv is None else argv)
    why = _refused(raw)
    if why:
        raise SystemExit(why)
    if raw and raw[0] == "events":
        # the reader's own flags belong to its parser
        from dcfm_tpu_torch.obs.cli import events_main
        return events_main(raw[1:])
    args = build_parser().parse_args(raw)
    if args.command == "serve":
        if args.workers > 1:
            from dcfm_tpu_torch.serve.fleet import fleet_main
            return fleet_main(args)
        from dcfm_tpu_torch.serve.server import serve_main
        return serve_main(args)
    if args.command == "export":
        from dcfm_tpu_torch.serve.artifact import export_main
        return export_main(args)
    if args.command == "promote":
        return _promote(args)
    if args.command == "delta":
        return _delta(args)
    return _fit(args)


def _promote(args) -> int:
    if args.delta:
        from dcfm_tpu_torch.serve.delta import DeltaArtifact
        from dcfm_tpu_torch.serve.promote import promote_delta
        st = promote_delta(args.root, args.candidate,
                           verify=not args.no_verify,
                           expect_generation=args.expect_generation)
        d = DeltaArtifact.open(
            args.candidate if os.path.isabs(args.candidate)
            else os.path.join(args.root, args.candidate))
        print(json.dumps({
            "promoted": st.target, "generation": st.generation,
            "fingerprint": st.fingerprint, "delta": True,
            "panels_changed": d.panels_changed,
            "bytes_shipped": d.bytes_shipped,
            "full_bytes": d.full_bytes}), flush=True)
        return 0
    from dcfm_tpu_torch.serve.promote import promote_artifact
    st = promote_artifact(args.root, args.candidate,
                          verify=not args.no_verify,
                          expect_generation=args.expect_generation)
    print(json.dumps({
        "promoted": st.target, "generation": st.generation,
        "fingerprint": st.fingerprint}), flush=True)
    return 0


def _delta(args) -> int:
    from dcfm_tpu_torch.serve.artifact import PosteriorArtifact
    from dcfm_tpu_torch.serve.delta import (materialize_delta,
                                            write_delta_artifact)
    from dcfm_tpu_torch.serve.promote import is_pointer_root, read_pointer
    base_path = args.base
    if is_pointer_root(base_path):
        base_path = read_pointer(base_path).path
    base = PosteriorArtifact.open(base_path)
    if args.apply:
        art = materialize_delta(base, args.candidate, args.out)
        print(json.dumps({
            "out": args.out, "applied": args.candidate,
            "fingerprint": art.fingerprint}), flush=True)
        return 0
    d = write_delta_artifact(args.candidate, base, args.out)
    print(json.dumps({
        "out": args.out, "base_fingerprint": d.base_fingerprint,
        "candidate_fingerprint": d.candidate_fingerprint,
        "panels_changed": d.panels_changed,
        "bytes_shipped": d.bytes_shipped,
        "full_bytes": d.full_bytes}), flush=True)
    return 0


def _fit(args) -> int:
    """The ``fit`` subcommand: the JAX CLI's checks, config, outputs,
    stderr convergence table and stdout JSON keys."""
    from dcfm_tpu_torch.api import fit
    from dcfm_tpu_torch.config import (
        BackendConfig, FitConfig, ModelConfig, RunConfig)
    from dcfm_tpu_torch.utils.checkpoint import retained_checkpoints

    Y = _load(args.data, sparse=args.sparse, mmap=args.mmap)
    if args.imputed_out and (args.sparse or args.mmap):
        raise SystemExit("--imputed-out is unsupported with --sparse/"
                         "--mmap (the completed matrix is dense (n, p))")
    if args.imputed_out and not np.isnan(np.asarray(Y)).any():
        raise SystemExit("--imputed-out set but Y has no missing (NaN) "
                         "entries")
    if args.factors % args.shards:
        raise SystemExit(
            f"--factors {args.factors} must be divisible by --shards "
            f"{args.shards} (k/g factors per shard)")
    if args.resume and not args.checkpoint:
        raise SystemExit("--resume requires --checkpoint")
    # resume when a checkpoint exists - a plain file, a retained .bakK or
    # a .procK-of-N set (which the resume refuses by name) - strictly: an
    # incompatible one is a refusal, never a silent fresh start
    resume = bool(args.resume and (
        retained_checkpoints(args.checkpoint)
        or glob.glob(glob.escape(args.checkpoint) + ".proc*-of-*")))
    cfg = FitConfig(
        model=ModelConfig(
            num_shards=args.shards,
            factors_per_shard=args.factors // args.shards,
            rho=args.rho, prior=args.prior, estimator=args.estimator,
            x_prior_precision=args.x_prior_precision,
            combine_dtype=args.combine_dtype,
            combine_chunks=args.combine_chunks,
            rank_adapt=args.rank_adapt, posterior_sd=args.posterior_sd),
        run=RunConfig(burnin=args.burnin, mcmc=args.mcmc, thin=args.thin,
                      seed=args.seed, chunk_size=args.chunk_size,
                      num_chains=args.chains,
                      store_draws=args.draws_out is not None,
                      early_stop=args.early_stop,
                      rhat_threshold=args.rhat_threshold,
                      ess_target=args.ess_target),
        backend=BackendConfig(backend=args.backend,
                              mesh_devices=args.mesh_devices,
                              fetch_dtype=args.fetch_dtype,
                              upload_dtype=args.upload_dtype,
                              compute_dtype=args.compute_dtype,
                              sse_mode=args.sse_mode,
                              profile_dir=args.profile_dir),
        permute=not args.no_permute,
        checkpoint_path=args.checkpoint,
        resume=resume,
        elastic=args.elastic,
        checkpoint_every_chunks=args.checkpoint_every,
        checkpoint_mode=args.checkpoint_mode,
        checkpoint_full_every=args.checkpoint_full_every,
        checkpoint_keep_last=args.keep_last,
        sentinel=args.sentinel,
        materialize_sigma=args.materialize_sigma,
    )
    res = fit(Y, cfg)
    if res.Sigma is None and not args.raw_coords:
        Sigma = None
        print("covariance not materialized (materialize_sigma="
              f"{cfg.materialize_sigma!r}, "
              f"{'lazy' if res.preprocess.is_lazy else 'dense'} input); "
              "no Sigma .npy written - query FitResult.sigma_block or "
              "serve via `dcfm-tpu-torch export`", file=sys.stderr)
    else:
        Sigma = (res.covariance(destandardize=False)
                 if args.raw_coords else res.Sigma)
    if Sigma is not None:
        np.save(args.out, Sigma)
    if args.draws_out:
        # single-chain draw files keep their chain-free layout, as the
        # JAX CLI writes them
        np.savez(args.draws_out,
                 **{k: v[0] if v.shape[0] == 1 else v
                    for k, v in res.draws.items()})
    if args.imputed_out:
        np.save(args.imputed_out, res.Y_imputed)
    sd_out = None
    if res.Sigma_sd is not None:
        root, ext = os.path.splitext(args.out)
        sd_out = f"{root}_sd{ext or '.npy'}"
        np.save(sd_out, res.posterior_sd(destandardize=False)
                if args.raw_coords else res.Sigma_sd)
    # the convergence table on stderr; stdout stays one JSON object
    chain_s = max(res.phase_seconds.get("chain_s", 0.0), 1e-9)
    ess_per_sec = {k: v / chain_s if np.isfinite(v) else None
                   for k, v in res.diagnostics["ess"].items()}
    rows = []
    for name, e in res.diagnostics["ess"].items():
        r = res.diagnostics["rhat"].get(name, float("nan"))
        rows.append((name,
                     f"{r:.4f}" if np.isfinite(r) else "-",
                     f"{e:.1f}" if np.isfinite(e) else "-",
                     f"{e / chain_s:.2f}" if np.isfinite(e) else "-"))
    w = max(len(r[0]) for r in rows) if rows else 8
    print(f"{'summary':<{w}}  {'R-hat':>8}  {'ESS':>9}  {'ESS/s':>8}",
          file=sys.stderr)
    for name, r, e, eps in rows:
        print(f"{name:<{w}}  {r:>8}  {e:>9}  {eps:>8}", file=sys.stderr)
    if cfg.run.early_stop == "off":
        print("early stop: off (full schedule, "
              f"{cfg.run.total_iters} iterations)", file=sys.stderr)
    elif res.stopped_at_iter is not None:
        print(f"early stop: converged at iteration "
              f"{res.stopped_at_iter}/{cfg.run.total_iters} "
              f"(R-hat < {cfg.run.rhat_threshold}, pooled ESS >= "
              f"{cfg.run.ess_target:g})", file=sys.stderr)
    else:
        print("early stop: did not trigger (ran the full "
              f"{cfg.run.total_iters} iterations)", file=sys.stderr)
    print(json.dumps({
        "out": args.out if Sigma is not None else None,
        "sd_out": sd_out,
        "draws_out": args.draws_out,
        "shape": (list(Sigma.shape) if Sigma is not None
                  else [res.preprocess.p_original] * 2),
        "seconds": round(res.seconds, 3),
        "compute_dtype": cfg.backend.compute_dtype,
        "sse_mode": cfg.backend.sse_mode,
        "iters_per_sec": round(res.iters_per_sec, 2),
        "chain_iters_per_sec": round(res.chain_iters_per_sec, 2),
        "phase_seconds": {k: round(v, 3)
                          for k, v in res.phase_seconds.items()},
        "tau_log_max": float(np.asarray(res.stats.tau_log_max)),
        "effective_rank_mean": float(np.asarray(res.stats.rank_mean)),
        "zero_cols_dropped": int(res.preprocess.zero_cols.size),
        "padded_cols": int(res.preprocess.n_pad),
        "missing_entries": int(res.preprocess.n_missing),
        # None (JSON null) for non-finite diagnostics: bare NaN is not
        # JSON (RFC 8259)
        "rhat": {k: round(v, 4) if np.isfinite(v) else None
                 for k, v in res.diagnostics["rhat"].items()},
        "ess": {k: round(v, 1) if np.isfinite(v) else None
                for k, v in res.diagnostics["ess"].items()},
        "ess_per_sec": {k: round(v, 2) if v is not None else None
                        for k, v in ess_per_sec.items()},
        "early_stop": cfg.run.early_stop,
        "stopped_at_iter": res.stopped_at_iter,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
