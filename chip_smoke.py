#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit, as nvidia-smi reports them),
   builds the native host assembler from dcfm_tpu_torch/native with g++
   (it must build: the fetch phase has no fallback), builds the
   hand-written kernels from dcfm_tpu_torch/csrc with nvcc for sm_90a (one
   nvcc per source, all started together) and prints the ptxas
   register/spill report.
2. Kernel phase: each of the five kernels (K1 chol_sample, K4
   chol_solve_sample, K3 cho_solve, K2 lam_update, K5 sse_ps) against its
   plain PyTorch version on the card, on identical inputs at the shapes the
   full-width fit gives it and at ragged shapes with K = 1, 4 and 16 (for
   the four lane-group kernels also K = 5, 7 and 13, which leave lanes
   idle, and for K2 a single shard and fewer rows than a block holds; for
   K5 also K = 5 and K = 24, the run-time-K route above 16), with the
   tolerance stated; the ptxas registers and spills of every templated
   kernel (a spill fails the run) and, from cuobjdump, the SASS
   instruction counts at K = 8; then the device time (torch.profiler)
   of the kernel, the plain version and one library yardstick, beside the
   least time the card could take, and the kernel's per-call time (CUDA
   events); for K1, where the host time of one wrapper call goes; and the
   card's floor for a launch of K5's size: an empty kernel and a streaming
   pass of K5's traffic (``floor: empty X us, K5-sized pass Y us``).
   ``python3 chip_smoke.py --kernels-only`` stops here, with no result
   line.
3. Graphs against the eager chain: one chain at the fit's width (below)
   for one chunk of 10 trips of T sweeps (burn-in 2 trips, thin 3), run
   eagerly and as CUDA graphs from the same init, at T = 8 along the three
   fit paths and the float32 path under sse_mode="resid", and at the
   fits' T (``CUDA_AUTO_UNROLL``) along the float32 path:
   the accumulator, every state leaf, health, the trace and the launch
   counts must be bitwise equal (``graph == eager`` lines give the max
   |graph - eager| of each; a difference names the first differing sweep
   and leaf); the graphs captured, their capture seconds and the graph
   pool's bytes.  Then the trip length behind ``CUDA_AUTO_UNROLL``: ms per
   sweep of one graphed chain at T = 1, 2, 4 and 8 (``unroll`` lines).
4. Fit phase: ``dcfm_tpu_torch.fit`` at the repo's north-star width
   (p = 10,000, g = 64 shards, n = 500, K = 8 factors per shard, 2 chains,
   sse_mode="auto") on synthetic factor data, along three paths: float32
   with lambda_kernel="pallas" (K1 and K5), compute_dtype="bf16" with
   lambda_kernel="auto" (K4 and K5) and lambda_kernel="pallas-fused" (K2
   and K5), each after a 4-sweep warm-up fit of the same path; every fit
   runs its chain as CUDA graphs (the card's only path), and prints the
   graphs it captured and the seconds the captures took (inside its
   chain time), its chain iterations/s (all chains' sweeps / chain_s) and
   its phase seconds.  The launch counters are zeroed just before each
   fit and read just after: each of the path's kernels must have launched
   once per sweep and every other kernel not at all.  Sigma must be finite
   and symmetric, the chains healthy, and its relative Frobenius error
   against the truth < 0.25 and at most twice the sample covariance's.  No
   fit path runs K3 (nor in the JAX package): its launches are counted
   over one call of its public op, ``cho_solve_batched``, at the fit's
   batch.  Each path then fits once more with upload_dtype="bfloat16",
   under the same checks.
5. Where the time goes, for each fit path: 48 more graphed sweeps of one
   chain at the same width and the fit's save mix (one draw in four
   accumulated), timed on the host clock and under torch.profiler: ms per
   sweep, the device's busy and idle share, and the kernels that take the
   most device time.
6. Fetch phase, on the float32 path at the same width: one fit per
   fetch_dtype (float32, bfloat16, float16, quant8) with Sigma assembled,
   and float32 and quant8 once more with materialize_sigma="never", each
   under step 4's checks where it has a Sigma (the launches in every fit).
   Per fit: fetch_s, exposed_fetch_s, assemble_s and the bytes that cross
   the link (``fetch`` lines).  Every fit runs the same chain, so the
   quant8 Sigma must lie within the quant8 rule's bound of the float32
   one, entry by entry: scale/254 of the entry's panel times the two
   column scales (plus float32 rounding of the products), and the packed
   fits must hold the assembled fits' panels bit for bit.  Then the
   quant8 and the packed quant8 results are exported as serve artifacts:
   seconds, bytes, and ``PosteriorArtifact.open(path).assemble()`` equal
   to the quant8 Sigma bit for bit.
7. Checkpoint phase, on the float32 path in chunks of 50: full, light and
   "auto" saves bitwise no checkpoint, a finished file resumed as a
   no-op, the divergence sentinel's abort and rewind on a chain the script
   poisons, quant8 streamed against post hoc; then on each path a child
   process SIGKILLed once its file reaches iteration 200 of 1,000 and
   resumed in a fresh one (``--fit-child SPEC``), Sigma bitwise the
   uninterrupted fit's (f32 also in light mode through its sidecar).
8. Posterior SD (``ModelConfig.posterior_sd``) on the float32 path:
   graphs against the eager chain with the second-moment accumulator
   (sigma_sq_acc bitwise too); fits under fetch_dtype float32 and quant8,
   each with K1 and K5 once per sweep and nothing else, Sigma bitwise the
   fit without posterior_sd, a finite non-negative SD, the quant8 SD
   within its quant8 bound of the float32 SD; chain iterations/s, peak
   allocated, and the graphed sweep's device busy time with the SD on.
9. Export from a checkpoint: the SD fit's full file, and a light file
   read through its ``.full`` sidecar, exported with
   ``serve.artifact.export_from_checkpoint``: mean panels and scales the
   fit's own ``export_artifact`` byte for byte, SD panels within one int8
   step; the seconds of each.
10. ``FitConfig.stream_artifact``: a quant8 SD fit whose stream lands in
   the artifact, against the post-hoc export of the same chain: panels,
   scales, maps and CRCs byte for byte; the exposed seconds.
11. Elastic chain counts: a 2-chain float32 child SIGKILLed after a full
   save, resumed at 1 and at 3 chains in fresh processes: the adoption's
   bookkeeping and divisor, the kernels once per executed sweep, and the
   rel. Frobenius error inside the quality rule.
12. Scenarios - the horseshoe and Dirichlet-Laplace priors and adaptive
   rank truncation: (a) graph == eager at the north-star width on data of
   true rank 4, 96 sweeps in trips of 8 with 64 of burn-in, on DL,
   horseshoe + rank_adapt, MGP + rank_adapt and horseshoe + rank_adapt
   under lambda_kernel="pallas-fused" (every rank_adapt path of this step
   at eps = 0.1, prop = 0.8, where columns drop and return inside the
   window; at the defaults no column of this data drops): every leaf
   bitwise, the prior's and the column mask among them, the mask read
   after every trip, the adaptations that fired printed (one must fire
   and a trip after the first must change the mask); (b) the DL fit at
   the north-star width (BASELINE config 4's prior on config 3's data),
   under step 4's checks, its quality also summed block by block (which
   must equal the dense figure), the graphed sweep's device time and the
   prior update's (its GIG rounds) share of it; the same two for the
   rank_adapt paths on the true-rank-4 data; (c)
   BASELINE config 5 on one card: horseshoe + rank_adapt at g = 256,
   P = 196, p = 50,176, n = 500, K = 8 on data of true rank 4, 2 chains of
   200 + 200 (thin 2), fetch_dtype="quant8" and
   materialize_sigma="never": K1 and K5 at its batch (50,176) against
   their plain versions, the memory reckoned and measured, each kernel
   once per sweep, the quality rule summed block by block on the card from
   ``sigma_block`` (no 50,176^2 matrix anywhere), the effective ranks,
   chain iterations/s and device busy per sweep; (d) horseshoe +
   rank_adapt over 600 + 400 iterations, a child SIGKILLed mid burn-in and
   resumed in a fresh process: Sigma and every state leaf, the mask
   included, bitwise the uninterrupted fit's, and ``export_from_checkpoint``
   of its file the resumed fit's own export byte for byte.
   ``python3 chip_smoke.py --scenarios-only`` runs the kernel phase and
   this step alone, with no result line.
13. The last scenario knobs, at the north-star width on the float32 path:
   (a) 10% of Y missing completely at random (``mcar``): graph == eager
   with the imputation sum ``y_imp_acc``; the fit with K1 and K5 once per
   sweep, no non-finite state, the quality rule against the truth (and
   the complete data's sample covariance), the imputation's RMSE at the
   missing entries below the column means'; device busy per sweep, the
   imputation's device time and share of it, the bytes of variates a
   sweep draws outside the graph and their device time; peak allocated; a
   child killed mid-run and resumed in a fresh process, Sigma, the state
   and Y_imputed bitwise; (b) ``store_draws``: graph == eager with the
   draw ring, Sigma bitwise the fit without it, the ring's bytes against
   the reckoning, the draw mean of 64 sampled entries against the
   accumulated mean, their 95% credible intervals bracketing it, the
   device time of a saved draw's ring writes; (c) ``early_stop="rhat"``
   (2 chains, burn-in 200, mcmc 800, chunks of 50), the thresholds picked
   from the uninterrupted run's own trajectory: the stop at the boundary
   picked, Sigma bitwise an early_stop="off" fit of that schedule, its
   checkpoint resumed with early_stop="off" bitwise the uninterrupted
   run; (d) the f32, bf16, fused and quant8 Sigma digests with every new
   knob off (``scripts/torch_sigma_hashes.py`` holds them against another
   tree).  ``python3 chip_smoke.py --knobs-only`` runs the kernel phase
   and this step alone, with no result line.
14. Scale on one card, the streaming ingest and the chunked combine:
   (a) config 5's data (step 12(c)) written as a float32 .npy and fitted
   from its np.memmap under step 12(c)'s config with
   materialize_sigma="auto" (packed: the input is lazy): the int8 panels
   and scales bitwise the dense fit's (step 12(c)'s digest, or a dense
   fit here), no Sigma and covariance() refused, K1 and K5 once per
   sweep, the quality rule block by block, chain iterations/s,
   preprocess_s and upload_s against the dense fit's, and the host peak
   of preprocess + upload in a fresh ``--fit-child`` process (VmRSS
   sampled from outside while the child ingests; its own ru_maxrss,
   which CUDA's start-up may already have set higher, beside it) - it
   must stay below half the dense (g, n, P) tensor; the dense array's
   beside it, and the reckoning); (b) the
   same with combine_chunks=16: graph == eager on one chain for 10
   trips, that chain's float32 accumulator against the unchunked
   chain's, the fit's int8 panels against (a)'s, peak allocated against
   (a)'s, one saved sweep's transient chunked and unchunked, device busy
   per sweep against the unchunked chain's with the add and GEMM
   kernels' times; (c) step 4's Y made sparse (|y| below its 90th
   percentile zeroed, 0.5% stored NaN, one all-zero column) fitted as a
   SparseMatrix CSR on the f32 path: the upper panels and, under
   materialize_sigma="always", Sigma bitwise the dense fit of the
   densified array, Y_imputed None, n_missing equal, K1 and K5 once per
   sweep.  ``python3 chip_smoke.py --ingest-only`` runs the kernel phase
   and this step alone, with no result line.
15. The outer layers, at the north-star width on the float32 path with
   quant8 streamed, chunks of 50 and unpermuted columns: (a) after a
   warm-up, a fit not recorded, one recorded into a directory, one under
   ``obs="auto"`` (landing in ``<checkpoint_path>.obs``) and one not
   recorded again, all checkpointed: Sigma bitwise across them,
   ``events_path``, the event log (``fit_start`` first, ``fit_done`` last,
   one fresh ``resume_decision``, one ``chunk`` per boundary summing to
   400 iterations, stream snapshots and drains, ``checkpoint_save`` up to
   iteration 400, ``fit_done``'s stream summary = ``stream_stats``), the
   gauges, the Chrome trace and ``summarize``; chain iterations/s recorded
   and not, the log's bytes and the boundary fsyncs' count and seconds;
   (d) ``backend="torch_cuda"`` bitwise the default fit, and a ``device=``
   contradicting ``backend`` (or a JAX backend name) refused before any
   card work; (b) ``profile_dir``: Sigma bitwise (a)'s, K1 and K5 among the
   trace's kernels once per sweep, the trip ranges, chain iterations/s
   against (d)'s unprofiled fit; (c) warm starts from (a)'s checkpoint
   (20 burn-in + 200): 100 appended rows and 8 new shards (p = 72 x 157),
   each decided warm with the donor's bytes in the first 64 shards'
   Lambda and psi, held to the quality rule beside a cold fit of the same
   schedule; graph == eager on two warm-started chains for one chunk; a
   K = 4 donor decided cold with the JAX reason, its initial state a plain
   fit's; a warm refit SIGKILLed in a child and resumed in a fresh one
   (decision resume, no re-graft) bitwise the uninterrupted warm refit.
   ``python3 chip_smoke.py --outer-only`` runs the kernel phase and this
   step alone, with no result line.
16. The serving plane on the card: (a) two short posterior-SD quant8
   fits at the north-star width exported (generations 1 and 2) and a
   delta of 64 changed mean panels against generation 2 (generation 3);
   (b) ``python -m dcfm_tpu_torch.cli serve`` on the card over a
   promotion root - /healthz names the card; 20,000 seeded entries, 50
   blocks, 20 full rows and 200 intervals over HTTP, every value bitwise
   ``PosteriorArtifact.assemble()`` (mean and SD); a 64-thread
   ``run_load`` (requests/s, p50/p99 per route, statuses, no untyped
   answer), the server's cache counters; the device bytes of a fully warm
   cache against the 410,159,360 B reckoning; (d) generation 2 promoted
   and then the delta, under a 64-thread storm: generation headers
   monotone per client, every answer its generation's assembly, each
   swap's seconds and adopted panels from the server's events; (c) BASELINE
   config 5's width (p = 50,176, g = 256, P = 196) as a sparse artifact
   filled from a seeded generator (1,263,732,736 B), stormed by 64
   threads under a 1 GiB cache (evictions > 0), every answer bitwise a
   CPU engine's; (e) a 2-worker fleet on the one card: each worker's
   start-up seconds, one SIGKILLed under load and respawned with no
   request dropped, SIGTERM draining both with exit 0; (f) the kernel
   launch counters read zero across the serving steps.
   ``python3 chip_smoke.py --serve-only`` runs the kernel phase and this
   step alone, with no result line.

Any failed check exits non-zero before the last line.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
dcfm_tpu_torch package beside this file, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOP_PER_S = 67e12          # H100 SXM float32 outside the tensor cores

FULL_B, FULL_K = 64 * 157, 8     # the Lambda / psi batch of the fit below
FIT = dict(p=10_000, n=500, k_true=8, g=64, K=8, rho=0.9, chains=2,
           burnin=200, mcmc=200, thin=2)


def say(line: str, out=sys.stdout) -> None:
    """One line of the script's console protocol, flushed at once."""
    print(line, file=out, flush=True)


def fail(msg: str) -> None:
    say(f"chip_smoke FAILED: {msg}", sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Per-call time of ``fn`` over ``reps`` back-to-back calls: CUDA events
    around the batch, after a warm-up.  When the host issues the calls
    slower than the card runs them, this is the host's issue rate."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_busy_ms(prof) -> tuple[float, list]:
    """Total device time of the kernels (and copies) a profiler window
    recorded, and the (name, ms) of the largest ones."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows


def device_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``: the summed durations of the kernels
    it launched under torch.profiler over ``reps`` calls, so host issue
    overhead is left out.  Falls back to CUDA events (host-inclusive) when
    the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy, _ = device_busy_ms(prof)
    if busy <= 0:
        say("torch.profiler recorded no device time: timing with CUDA "
            "events instead")
        return cuda_ms(fn, reps)
    return busy / reps


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def solve_flops(K: int, noise: bool, recip: bool) -> int:
    """Arithmetic of one K x K factor-solve(-sample), as the kernels do it
    (each multiply, add, divide and square root counted once): Cholesky,
    forward solve, one or two backward solves dividing by L_jj or
    multiplying by its reciprocal, and the final m + y."""
    per = 2 if noise else 1
    chol = sum(2 * (K - j) * j + 1 + (K - 1 - j) for j in range(K))
    fwd = sum(2 * j + 1 for j in range(K))
    bwd = sum(2 * per * (K - 1 - j) + per + recip for j in range(K))
    return chol + fwd + bwd + (K if noise else 0)


def spd(A: np.ndarray) -> np.ndarray:
    """(B, K, K) SPD precisions A A' + 2I from (B, K, K) draws A."""
    K = A.shape[-1]
    return A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(K, dtype=np.float32)


# tolerance of the four factor-solve kernels against their plain versions:
# the plain versions repeat the kernels' operation order (reciprocal or
# division alike), but nvcc contracts mul+sub into FMA; the precisions are
# well conditioned (Q = A A' + 2I, or diag(plam) + ps E with plam > 0.1),
# so float32 rounding stays far inside 2e-4 abs + 2e-4 rel (the bound the
# JAX package holds its Pallas kernel to against the unrolled version)
SOLVE_RTOL = SOLVE_ATOL = 2e-4


def compare(torch, label: str, out, ref) -> float:
    """Max |kernel - plain|; fails the run outside the solve tolerance."""
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    ok = bool(torch.all((out - ref).abs() <= SOLVE_ATOL
                        + SOLVE_RTOL * ref.abs()))
    say(f"{label}: max_abs_err={err:.3e} (tolerance {SOLVE_ATOL:g} + "
        f"{SOLVE_RTOL:g}*|plain|) {'ok' if ok else 'MISMATCH'}")
    check(ok and math.isfinite(err), f"{label} disagrees with its plain "
          "version")
    return err


def timings(torch, kernel, plain, library, args, label: str,
            plain_reps: int) -> dict:
    """Device times of the kernel, its plain version and the library
    yardstick on ``args``, and the kernel's per-call time; the yardstick
    must compute the same function."""
    check(float((library(*args) - plain(*args)).abs().max()) < 1e-3,
          f"{label} library yardstick computes another function")
    return dict(ms=device_ms(lambda: kernel(*args), 200),
                call_ms=cuda_ms(lambda: kernel(*args), 200),
                plain_ms=device_ms(lambda: plain(*args), plain_reps),
                library_ms=device_ms(lambda: library(*args), 50))


def library_sample(torch):
    """x = Q^{-1} b + L^{-T} z through torch.linalg: Cholesky, then two
    triangular solves (the second takes [v, z] as one right-hand side)."""
    def run(Q, b, z):
        L = torch.linalg.cholesky(Q)
        v = torch.linalg.solve_triangular(L, b[..., None], upper=False)
        mz = torch.linalg.solve_triangular(
            L.mT, torch.cat([v, z[..., None]], dim=-1), upper=True)
        return mz.sum(dim=-1)
    return run


# the shapes each factor-solve kernel is held to its plain version at: the
# fit's batch, then K = 1, 4 and 16 on a batch ragged against every block
SOLVE_SHAPES = ((FULL_B, FULL_K), (FULL_B + 1, 1), (FULL_B + 1, 4),
                (FULL_B + 1, 16))
# and, since the lane groups are W >= K lanes wide (W a power of two), K
# that leave lanes idle, on batches ragged against the group
GROUP_SHAPES = SOLVE_SHAPES + ((FULL_B + 1, 5), (FULL_B + 1, 13), (33, 5),
                               (3, 13), (1, 7))


def solve_phase(torch, rng, tag: str, name: str, kernel, plain, library,
                noise: bool, recip: bool, source: str, replaces: str,
                shapes=SOLVE_SHAPES) -> dict:
    """One of the batched factor-solve kernels (K1, K4, K3) against its
    plain version at ``shapes`` (the full-width batch first); times at the
    full-width shape."""
    dev = torch.device("cuda")
    for B, K in shapes:
        args = [torch.as_tensor(spd(rng.standard_normal((B, K, K),
                                                        np.float32)),
                                device=dev)]
        args += [torch.as_tensor(rng.standard_normal((B, K), np.float32),
                                 device=dev) for _ in range(1 + noise)]
        err = compare(torch, f"{tag} {name} B={B} K={K}", kernel(*args),
                      plain(*args))
        if (B, K) == (FULL_B, FULL_K):
            worst, full = err, args
    B, K = FULL_B, FULL_K
    t = timings(torch, kernel, plain, library, full, tag, 20)
    bnd, by = bound_ms(4.0 * B * (K * K + (3 if noise else 2) * K),
                       B * solve_flops(K, noise, recip))
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=worst, bound_ms=bnd, bound_by=by, **t)


def host_us(torch, fn, calls: int = 2000) -> float:
    """Host time per call of ``fn`` on the host clock (the card runs any
    launches behind it), after a warm-up."""
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / calls * 1e6


def k1_phase(torch, k1, cuda_lib, rng, card: str) -> dict:
    rec = solve_phase(torch, rng, "K1", "chol_sample", k1.chol_sample,
                      k1.chol_sample_plain, library_sample(torch),
                      noise=True, recip=True,
                      source="dcfm_tpu_torch/csrc/chol_sample.cu",
                      replaces="dcfm_tpu/ops/pallas_gaussian.py:44",
                      shapes=GROUP_SHAPES)
    # where the host time of one wrapper call goes, at the fit's batch
    Q = torch.as_tensor(spd(rng.standard_normal((FULL_B, FULL_K, FULL_K),
                                                np.float32)), device="cuda")
    b, z = (torch.as_tensor(rng.standard_normal((FULL_B, FULL_K), np.float32),
                            device="cuda") for _ in range(2))
    out = torch.empty_like(b)
    parts = {
        "input check": lambda: k1.check_systems(Q, b=b, z=z),
        "output allocation": lambda: torch.empty_like(b),
        "launch (cuda_lib.launch: stream, ctypes, CUDA launch, count)":
            lambda: cuda_lib.launch(
                "chol_sample", "dcfm_chol_sample", Q.device, Q.data_ptr(),
                b.data_ptr(), z.data_ptr(), out.data_ptr(), FULL_B, FULL_K),
        "whole wrapper": lambda: k1.chol_sample(Q, b, z)}
    say("K1 host time per wrapper call (host clock, 2,000 calls): " + ", "
        .join(f"{name} {host_us(torch, fn):.2f} us"
              for name, fn in parts.items()) + f"; {card}")
    return rec


def k4_phase(torch, bs, rng) -> dict:
    return solve_phase(torch, rng, "K4", "chol_solve_sample",
                       bs.chol_solve_sample_batched,
                       bs.chol_solve_sample_plain, library_sample(torch),
                       noise=True, recip=False,
                       source="dcfm_tpu_torch/csrc/batched_solve.cu",
                       replaces="dcfm_tpu/ops/batched_solve.py:247",
                       shapes=GROUP_SHAPES)


def k3_phase(torch, bs, rng) -> dict:
    def library(Q, b):
        return torch.cholesky_solve(b[..., None],
                                    torch.linalg.cholesky(Q))[..., 0]
    return solve_phase(torch, rng, "K3", "cho_solve", bs.cho_solve_batched,
                       bs.cho_solve_plain, library, noise=False, recip=False,
                       source="dcfm_tpu_torch/csrc/batched_solve.cu",
                       replaces="dcfm_tpu/ops/batched_solve.py:238",
                       shapes=GROUP_SHAPES)


def lam_operands(torch, rng, G: int, P: int, K: int) -> list:
    """The fused update's operands as the sweep forms them: E = eta'eta
    (SPD), prior precisions plam > 0.1, ps > 0, data terms, normals."""
    A = rng.standard_normal((G, K, K)).astype(np.float32)
    ops = [A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(K, dtype=np.float32),
           (rng.gamma(2.0, 1.0, (G, P, K)) + 0.1).astype(np.float32),
           rng.gamma(3.0, 0.5, (G, P)).astype(np.float32),
           rng.standard_normal((G, P, K)).astype(np.float32),
           rng.standard_normal((G, P, K)).astype(np.float32)]
    return [torch.as_tensor(a, device="cuda") for a in ops]


def k2_phase(torch, k2) -> dict:
    """K2 against its plain version at the fit's (G, P, K), at ragged
    shapes with K = 1, 4, 16, at K = 5, 7, 13 that leave lanes of a group
    idle, at a single shard and at fewer rows than one block holds."""
    for G, P, K in ((64, 157, FULL_K), (3, 33, 1), (5, 157, 4),
                    (2, 65, 16), (3, 157, 5), (2, 33, 7), (5, 65, 13),
                    (1, 157, 8), (1, 5, 3), (2, 7, 16)):
        args = lam_operands(torch, np.random.default_rng(200 + K), G, P, K)
        err = compare(torch, f"K2 lam_update G={G} P={P} K={K}",
                      k2.lam_update(*args), k2.lam_update_plain(*args))
        if (G, K) == (64, FULL_K):
            worst, full = err, args
    G, P, K = 64, 157, FULL_K
    sample = library_sample(torch)

    def library(E, plam, ps, EYt, Zn):
        # what the fused kernel saves: forming Q and b in device memory,
        # then the library sampler
        Q = torch.diag_embed(plam) + ps[..., None, None] * E[:, None]
        b = ps[..., None] * EYt
        return sample(Q.reshape(G * P, K, K), b.reshape(G * P, K),
                      Zn.reshape(G * P, K)).reshape(G, P, K)

    t = timings(torch, k2.lam_update, k2.lam_update_plain, library, full,
                "K2", 20)
    # reads E, plam, ps, ey, z once and writes x; forms the lower triangle
    # of Q (K(K+1)/2 products, K diagonal adds) and b (K products) per row
    bnd, by = bound_ms(4.0 * (G * K * K + G * P * (3 * K + 1) + G * P * K),
                       G * P * (solve_flops(K, True, True)
                                + K * (K + 1) // 2 + 2 * K))
    return dict(name="lam_update", route="cuda",
                source="dcfm_tpu_torch/csrc/lam_rows.cu",
                replaces="dcfm_tpu/ops/pallas_gaussian.py:119",
                max_abs_err=worst, bound_ms=bnd, bound_by=by, **t)


def sse_operands(torch, rng, B: int, K: int) -> list:
    """K5's operands (Lam, M, EYt, yty, g) with a known SSE: the first
    eighth of the features cancel to ~0 and the next eighth overshoot to
    -1e-3, which must clamp to exactly 0."""
    Lam = rng.standard_normal((B, K)).astype(np.float32)
    M = rng.standard_normal((B, K)).astype(np.float32)
    EYt = rng.standard_normal((B, K)).astype(np.float32) * 5
    quad = np.sum(Lam.astype(np.float64) * M, axis=1)
    dot2 = np.sum(Lam.astype(np.float64) * EYt, axis=1)
    sse_true = rng.uniform(0.0, 500.0, B)
    sse_true[:B // 8] = 0.0
    sse_true[B // 8:B // 4] = -1e-3
    yty = (sse_true + 2 * dot2 - quad).astype(np.float32)
    g = rng.gamma(250.5, 1.0, B).astype(np.float32)
    return [torch.as_tensor(a, device="cuda") for a in (Lam, M, EYt, yty, g)]


def k5_compare(torch, label: str, got, t, bs: float) -> float:
    """(ps, sse) of a K5 kernel against the plain version on operands t."""
    from dcfm_tpu_torch.ops.sse_gamma import sse_ps_plain
    ps, sse = got
    ps_p, sse_p = sse_ps_plain(*t, bs)
    torch.cuda.synchronize()
    B, K = t[0].shape
    # tolerance: both sum K products in float32 in other orders (and the
    # kernel with FMA), so the three-term SSE differs by at most a few
    # ulp of its largest term; ps inherits that through the rate
    eps = float(np.finfo(np.float32).eps)
    Lt, Mt, Et, yt = t[0], t[1], t[2], t[3]
    scale = yt.abs() + 2 * (Lt * Et).abs().sum(-1) + (Lt * Mt).abs().sum(-1)
    tol_sse = 4 * K * eps * scale
    tol_ps = ps_p.abs() * (tol_sse / (2 * bs + sse_p) + 4 * eps)
    ok = bool(torch.all((sse - sse_p).abs() <= tol_sse)
              and torch.all((ps - ps_p).abs() <= tol_ps)
              and torch.all(sse[B // 8:B // 4] == 0) and torch.all(sse >= 0))
    err = max(float((sse - sse_p).abs().max()), float((ps - ps_p).abs().max()))
    say(f"{label} B={B} K={K}: max_abs_err={err:.3e} (tolerance "
        f"4*K*eps*|terms| on sse, propagated to ps; clamp rows exact) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok and math.isfinite(err), f"{label} disagrees with its plain "
          "version")
    return err


def k5_phase(torch, k5, cuda_lib, card: str) -> tuple:
    """K5 against its plain version at the full-width shape, at K = 1, 4,
    5 and 16 and K = 24 (the run-time-k route of K > 16) on batches ragged
    against the block, with rows whose SSE cancels to (or below) zero so
    the clamp is exercised; then the card's floor beside it: an empty
    kernel and a streaming pass of K5's traffic on K5's grid.  Returns the
    kernel's record and the pass's device time in ms."""
    bs = 0.3
    for B, K in ((FULL_B, FULL_K), (FULL_B + 1, 1), (FULL_B + 1, 4),
                 (700, 5), (FULL_B + 1, 16), (FULL_B + 1, 24), (129, 24),
                 (9, 8)):
        ops = sse_operands(torch, np.random.default_rng(500 + B + K), B, K)
        e = k5_compare(torch, "K5 sse_ps", k5.sse_ps(*ops, bs=bs), ops, bs)
        if (B, K) == (FULL_B, FULL_K):
            err, t = e, ops
    B, K = FULL_B, FULL_K

    def library():
        q = torch.linalg.vecdot(t[0], t[1])
        d = torch.linalg.vecdot(t[0], t[2])
        s = torch.clamp(t[3] - 2.0 * d + q, min=0.0)
        return t[4] / (bs + 0.5 * s), s

    ms = device_ms(lambda: k5.sse_ps(*t, bs=bs), 200)
    call = cuda_ms(lambda: k5.sse_ps(*t, bs=bs), 200)
    plain = device_ms(lambda: k5.sse_ps_plain(*t, bs), 100)
    lib = device_ms(library, 100)
    bnd, by = bound_ms(4.0 * B * (3 * K + 2) + 4.0 * 2 * B,
                       B * (4.0 * K + 5))

    # the floor: neither is a port of anything nor counted as a launch
    dev = t[0].device
    ps, sse = torch.empty_like(t[3]), torch.empty_like(t[3])
    ptrs = [a.data_ptr() for a in (*t, ps, sse)]
    empty = device_ms(lambda: cuda_lib.call("dcfm_floor_empty", dev), 200)
    sized = device_ms(lambda: cuda_lib.call("dcfm_floor_pass", dev, *ptrs,
                                            B, K), 200)
    say(f"floor: empty {empty * 1e3:.2f} us, K5-sized pass "
        f"{sized * 1e3:.2f} us; {card}")
    return dict(name="sse_ps", route="cuda",
                source="dcfm_tpu_torch/csrc/sse_ps.cu",
                replaces="dcfm_tpu/ops/sse_gamma.py:127",
                max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib), sized


def synthetic(n: int, p: int, k_true: int, noise: float = 0.2,
              seed: int = 0):
    """Y = F L' + noise * eps with known Sigma = L L' + noise^2 I."""
    r = np.random.default_rng(seed)
    L = r.normal(size=(p, k_true)) / np.sqrt(k_true)
    F = r.normal(size=(n, k_true))
    Y = F @ L.T + noise * r.normal(size=(n, p))
    return Y.astype(np.float32), L.astype(np.float32), noise


# the fit paths: (label, ModelConfig knobs, BackendConfig knobs, the kernels
# that must launch once per sweep; every other kernel must not launch)
FIT_PATHS = (
    ("f32", {"lambda_kernel": "pallas"}, {}, ("chol_sample", "sse_ps")),
    ("bf16", {"lambda_kernel": "auto"}, {"compute_dtype": "bf16"},
     ("chol_solve_sample", "sse_ps")),
    ("fused", {"lambda_kernel": "pallas-fused"}, {},
     ("lam_update", "sse_ps")),
)


def graph_pool_bytes(torch):
    """Bytes the caching allocator holds in graph pools (every segment
    outside the default pool), or None if the snapshot does not say."""
    segs = torch.cuda.memory_snapshot()
    if not any("segment_pool_id" in s for s in segs):
        return None
    return sum(s["total_size"] for s in segs
               if tuple(s.get("segment_pool_id", (0, 0))) != (0, 0))


def path_config(dt, model: dict, backend: dict):
    c = FIT
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=c["g"], factors_per_shard=c["K"],
                             rho=c["rho"], **model),
        run=dt.RunConfig(burnin=c["burnin"], mcmc=c["mcmc"], thin=c["thin"],
                         seed=0, num_chains=c["chains"]),
        backend=dt.BackendConfig(**({"sse_mode": "auto"} | backend)))


def chain_setup(torch, cfg, Y):
    """(model config with the backend's sweep knobs, data on the card,
    prior) as ``fit`` builds them."""
    from dcfm_tpu_torch.models.priors import make_prior
    from dcfm_tpu_torch.utils.preprocess import preprocess
    m = dataclasses.replace(cfg.model, sse_mode=cfg.backend.sse_mode,
                            compute_dtype=cfg.backend.compute_dtype)
    Yd = torch.as_tensor(preprocess(Y, m.num_shards, seed=0).data,
                         device="cuda")
    return m, Yd, make_prior(m)


# the leaves in the order the sweep writes them: the first of these that
# differs names the conditional where graph and eager part
SWEEP_ORDER = ("Z", "X", "Lambda", "delta", "psijh", "lam2", "nu", "tau2",
               "xi", "phi", "tau", "psi", "ps", "active", "sigma_acc",
               "sigma_sq_acc", "y_imp_acc", "draws.Lambda", "draws.ps",
               "draws.X", "draws.H", "health")


def adapt_fires(m, burnin: int) -> int:
    """How many of the first ``burnin`` iterations of chain 0 (seed 0)
    adapt: the coin each one draws at the adaptation site (the first and
    only draw of its stream) below p(t) = exp(a0 + a1 t)."""
    import torch

    from dcfm_tpu_torch.noise import SITE_ADAPT, TorchNoise
    noise = TorchNoise(0, "cuda")
    a = m.adapt
    return sum(
        float(noise.sweep(0, i).uniform(SITE_ADAPT, ()))
        < float(torch.exp(a.a0 + a.a1 * torch.tensor(float(i + 1))))
        for i in range(burnin))


def graph_equality_phase(torch, cuda_lib, cfg, Y, card: str, label: str,
                         T: int, trips: int = 10, burn_trips: int = 2,
                         num_stored_draws: int = 0):
    """One chain, ``trips`` trips of T sweeps (burn-in ``burn_trips``
    trips, thin 3), eager and graphed from the same init: every leaf (the
    prior's and, under rank adaptation, the column mask), the
    accumulator, health, the trace, the imputation sum (NaN in Y), the
    draw ring of ``num_stored_draws`` slots and the launches bitwise.
    Under rank adaptation each trip is a chunk of its own, so the mask is
    read after every trip: the adaptations that fired and the trips that
    changed it are printed.  Returns the graphed chain's accumulator."""
    from dcfm_tpu_torch.models.sampler import (
        ChainRunner, DrawBuffers, state_leaves)
    from dcfm_tpu_torch.noise import TorchNoise
    from dcfm_tpu_torch.utils.checkpoint import state_leaf_names
    m, Yd, prior = chain_setup(torch, cfg, Y)
    label = f"{label}, T={T}"
    got, peak, masks = {}, {}, {}
    chunks = [T] * trips if m.rank_adapt else [trips * T]
    for graphs in (False, True):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior,
                             burnin=burn_trips * T, thin=3, unroll=T,
                             graphs=graphs,
                             num_stored_draws=num_stored_draws)
        carry = runner.init_chain(0)
        cuda_lib.reset_launch_counts()
        t = time.perf_counter()
        traces, masks[graphs] = [], []
        for n in chunks:
            carry, _, tr = runner.run_chunk(0, carry, n)
            traces.append(tr)
            if m.rank_adapt:
                masks[graphs].append(carry.state.active.clone())
        trace = torch.cat(traces)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak[graphs] = torch.cuda.max_memory_allocated() - base
        got[graphs] = dict(zip(state_leaf_names(m),
                               state_leaves(carry.state)),
                           sigma_acc=carry.sigma_acc, health=carry.health,
                           trace=trace, launches=cuda_lib.launch_counts())
        if carry.sigma_sq_acc is not None:
            got[graphs]["sigma_sq_acc"] = carry.sigma_sq_acc
        if carry.y_imp_acc is not None:
            got[graphs]["y_imp_acc"] = carry.y_imp_acc
        if carry.draws is not None:
            got[graphs].update(
                (f"draws.{k}", t) for k, t in zip(DrawBuffers._fields,
                                                  carry.draws)
                if t is not None)
        if graphs:
            pool = graph_pool_bytes(torch)
            say(f"graphs [{label}]: {trips * T} sweeps in {wall:.3f} s, "
                f"{runner.captured} graphs captured in "
                f"{runner.capture_s:.3f} s, {runner.replays} replays, "
                f"{runner.eager_trips} eager trips; graph pool "
                f"{'not measured' if pool is None else f'{pool} bytes'} "
                f"reserved; peak allocated above the data: eager "
                f"{peak[False]} bytes, graphed {peak[True]} bytes ({card})")
        del runner, carry
    e, g = got[False], got[True]
    check(g["launches"] == e["launches"], f"[{label}] launches under graphs "
          f"{g['launches']} != eager {e['launches']}")
    diff = {k: float((g[k] - e[k]).abs().max()) for k in e if k != "launches"}
    say(f"graph == eager [{label}]: max |graph - eager| "
        + ", ".join(f"{k} {v:g}" for k, v in diff.items())
        + f"; launches {json.dumps(g['launches'])}")
    if m.rank_adapt:
        fires = adapt_fires(m, burn_trips * T)
        ranks = [int(x.sum()) for x in masks[True]]
        changed = sum(not torch.equal(a, b) for a, b in
                      zip(masks[True][1:], masks[True][:-1]))
        same_masks = all(torch.equal(a, b) for a, b in
                         zip(masks[True], masks[False]))
        say(f"adapt [{label}]: adaptation fired {fires} times in "
            f"{burn_trips * T} burn-in sweeps; active columns of all shards "
            f"after each trip {ranks} ({changed} trips changed the mask "
            f"after the first); graph masks == eager masks after every "
            f"trip: {same_masks}")
        check(fires >= 1 and changed >= 1, f"[{label}] adaptation fired "
              f"{fires} times and changed the mask after the first trip "
              f"{changed} times in the window")
        check(same_masks, f"[{label}] a trip's mask differs under graphs")
    same = {k: bool(torch.equal(g[k], e[k])) for k in diff}
    if not all(same.values()):
        rows = (g["trace"] != e["trace"]).any(dim=1).nonzero()
        first = int(rows[0]) + 1 if len(rows) else None
        leaf = next((k for k in SWEEP_ORDER if not same.get(k, True)), None)
        fail(f"[{label}] the graphed chain is not the eager chain: first "
             f"differing trace row at sweep {first}, first differing leaf "
             f"in sweep order {leaf} (differing: "
             f"{[k for k, v in same.items() if not v]})")
    acc = g["sigma_acc"]
    del got, e, g
    torch.cuda.empty_cache()
    return acc


def unroll_phase(torch, cfg, Y, card: str) -> None:
    """ms per sweep of one graphed chain at the fit's width and save mix
    (one draw in four) for trips of T = 1, 2, 4 and 8 sweeps, in turns
    (1, 2, 4, 8, 8, 4, 2, 1, 1, 2, 4, 8): a 16-sweep chunk meets and
    captures every pattern (timed, with its captures: a fit's first-use
    cost), then a 96-sweep chunk of replays is timed on the host clock."""
    from dcfm_tpu_torch.api import CUDA_AUTO_UNROLL
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import TorchNoise
    m, Yd, prior = chain_setup(torch, cfg, Y)
    times = {}
    for T in (1, 2, 4, 8, 8, 4, 2, 1, 1, 2, 4, 8):
        runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=0,
                             thin=4, unroll=T)
        carry = runner.init_chain(0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        runner.run_chunk(0, carry, 16)
        torch.cuda.synchronize()
        first = time.perf_counter() - t
        t = time.perf_counter()
        runner.run_chunk(0, carry, 96)
        torch.cuda.synchronize()
        times.setdefault(T, []).append((time.perf_counter() - t) * 1e3 / 96)
        pool = graph_pool_bytes(torch)
        say(f"unroll T={T}: {times[T][-1]:.4f} ms per sweep (96 graphed "
            f"sweeps, host clock); first 16 sweeps {first:.3f} s with "
            f"{runner.captured} captures ({runner.capture_s:.3f} s); graph "
            f"pool {'not measured' if pool is None else f'{pool} bytes'}; "
            f"{card}")
        del runner, carry
        torch.cuda.empty_cache()
    med = {T: sorted(v)[len(v) // 2] for T, v in times.items()}
    say("unroll: median ms per sweep " + ", ".join(
        f"T={T} {v:.4f}" for T, v in med.items())
        + f"; fastest T={min(med, key=med.get)}; "
        f"CUDA_AUTO_UNROLL={CUDA_AUTO_UNROLL}")


def fit_phase(torch, dt, cuda_lib, card: str, label: str, model: dict,
              backend: dict, kernels: tuple, Y, L, noise) -> tuple:
    """One full-width fit along a path; returns (launches, config, rel.
    Frobenius error against the truth, the result)."""
    c = FIT
    cfg = path_config(dt, model, backend)
    # warm-up: 4 sweeps of the same path and width, so that the timed fit
    # pays no first-use cost (library loads, new GEMM shapes) that a path
    # timed later would not pay
    dt.fit(Y, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2, mcmc=2)))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = dt.fit(Y, cfg)                                  # device="cuda"
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    say(f"fit [{label}]: {sweeps} sweeps in "
        f"{res.phase_seconds['chain_s']:.3f} s chain time = "
        f"{sweeps / res.phase_seconds['chain_s']:.2f} chain iterations/s "
        f"(wall {wall:.3f} s; {card})")
    say(f"fit [{label}] phase_seconds: " + json.dumps(res.phase_seconds))
    say(f"fit [{label}] graphs: {json.dumps(res.graphs)} (capture_s is "
        "inside chain_s)")
    say(f"fit [{label}] peak device memory: {peak} bytes allocated "
        f"({peak / 2**30:.3f} GiB), {peak_reserved} bytes reserved "
        f"({card})")
    err = check_fit(torch, res, launches, label, kernels, Y, L, noise)
    return launches, cfg, err, res


def check_fit(torch, res, launches: dict, label: str, kernels: tuple, Y,
              L, noise) -> float:
    """A fit's checks: CUDA graphs ran; each of the path's kernels launched
    once per sweep and every other kernel not at all (``launches``, the
    counters zeroed just before the fit and read just after); healthy
    chains; and, where the fit assembled Sigma, a finite, symmetric Sigma
    within the quality rule.  Returns the rel. Frobenius error against
    the truth (None without a Sigma)."""
    c = FIT
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    check(res.graphs["captured"] > 0 and res.graphs["replays"] > 0,
          f"[{label}] the fit ran no CUDA graph: {res.graphs}")
    say(f"fit [{label}] kernel launches: {json.dumps(launches)} "
        f"(expected {sweeps} for {', '.join(kernels)}, 0 for the others)")
    for name, count in launches.items():
        want = sweeps if name in kernels else 0
        check(count == want, f"[{label}] {name} launched {count} times in "
              f"{sweeps} sweeps, expected {want}")
    return check_quality(torch, res, label, Y, L, noise)


def check_quality(torch, res, label: str, Y, L, noise) -> float:
    """Healthy chains and, where the fit assembled Sigma, a finite,
    symmetric Sigma within the quality rule; returns the rel. Frobenius
    error against the truth (None without a Sigma)."""
    c = FIT
    check(res.stats.nonfinite_count == 0 and res.stats.acc_nonfinite == 0,
          f"chain health: {res.stats}")
    S = res.Sigma
    if S is None:
        return None
    check(S.shape == (c["p"], c["p"]), f"Sigma shape {S.shape}")
    check(bool(np.isfinite(S).all()), "Sigma has non-finite entries")
    Sd = torch.as_tensor(S, device="cuda")
    asym = float((Sd - Sd.T).abs().max() / Sd.abs().max())
    check(asym <= 1e-6, f"Sigma asymmetric (max rel {asym:.2e})")
    del Sd
    err, err_sample = rel_errors(torch, S, Y, L, noise)
    say(f"fit [{label}] rel Frobenius error vs truth: {err:.6f} "
        f"(sample covariance: {err_sample:.6f})")
    check(err < 0.25, f"[{label}] rel Frobenius error {err:.4f} >= 0.25")
    check(err <= 2 * err_sample, f"[{label}] rel Frobenius error "
          f"{err:.4f} > 2x the sample covariance's")
    return err


def counted_fit(torch, dt, cuda_lib, cfg, Y) -> tuple:
    """One fit with the launch counters zeroed just before and read just
    after; returns (result, launches, wall seconds)."""
    torch.cuda.synchronize()
    cuda_lib.reset_launch_counts()
    t = time.perf_counter()
    res = dt.fit(Y, cfg)                                  # device="cuda"
    wall = time.perf_counter() - t
    return res, cuda_lib.launch_counts(), wall


def upload_phase(torch, dt, cuda_lib, card: str, Y, L, noise) -> None:
    """Each fit path once with upload_dtype="bfloat16": the data crosses
    the link as bfloat16 and is widened to float32 on the card."""
    for label, model, backend, kernels in FIT_PATHS:
        cfg = path_config(dt, model, backend | {"upload_dtype": "bfloat16"})
        res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
        label = f"{label}, upload bfloat16"
        say(f"fit [{label}]: upload_s {res.phase_seconds['upload_s']:.4f} "
            f"(float32 data: {Y.nbytes} bytes, bfloat16 on the link: "
            f"{Y.nbytes // 2} bytes), wall {wall:.3f} s; {card}")
        check_fit(torch, res, launches, label, kernels, Y, L, noise)


def link_bytes(res) -> int:
    """The bytes of the posterior-mean panels that crossed the link: the
    g(g+1)/2 panels in the fetch dtype, and quant8's float32 scales."""
    if res._q8_panels is not None:
        return res._q8_panels.nbytes + res._q8_scales.nbytes
    pre = res.preprocess
    g, P = pre.num_shards, pre.shard_size
    size = {"float32": 4, "bfloat16": 2,
            "float16": 2}[res.config.backend.fetch_dtype]
    return g * (g + 1) // 2 * P * P * size


def quant8_bound(torch, q8, f32, card: str, kind: str = "mean") -> None:
    """|Sigma_q8 - Sigma_f32| entry by entry against the quant8 rule: the
    int8 panel is off by at most scale/254 of its panel, and the assembly
    multiplies by the two column scales; float32 rounding of the products
    adds a few ulps of the entry (8 eps |Sigma_f32| allowed).  ``kind``
    "sd" holds Sigma_sd to the same rule with the SD panels' scales."""
    from dcfm_tpu_torch.utils.preprocess import caller_to_shard_index
    dev = torch.device("cuda")
    pre = q8.preprocess
    g, P = pre.num_shards, pre.shard_size
    idx = caller_to_shard_index(pre, np.arange(pre.p_original))
    ok = torch.as_tensor(idx >= 0, device=dev)
    shard = torch.as_tensor(idx[idx >= 0] // P, device=dev)
    s = torch.as_tensor(pre.col_scale.reshape(-1)[idx[idx >= 0]], device=dev)
    r, c = np.triu_indices(g)
    grid = torch.zeros((g, g), dtype=torch.float32, device=dev)
    sd = kind == "sd"
    scales = torch.as_tensor(q8._sd_q8_scales if sd else q8._q8_scales,
                             device=dev)
    grid[r, c] = scales
    grid[c, r] = scales
    bound = grid[shard][:, shard] / 254.0 * (s[:, None] * s[None, :])
    Sq = torch.as_tensor(q8.Sigma_sd if sd else q8.Sigma,
                         device=dev)[ok][:, ok]
    Sf = torch.as_tensor(f32.Sigma_sd if sd else f32.Sigma,
                         device=dev)[ok][:, ok]
    diff = (Sq - Sf).abs()
    slack = 8 * float(np.finfo(np.float32).eps) * Sf.abs()
    worst = float((diff - bound - slack).max())
    ratio = float((diff / torch.clamp(bound, min=1e-30)).max())
    say(f"fetch quant8 vs float32 Sigma{'_sd' if sd else ''}: max |diff| "
        f"{float(diff.max()):.4e}, "
        f"max bound (scale/254 x s_i x s_j) {float(bound.max()):.4e}, max "
        f"|diff| / bound {ratio:.6f} (limit 1 + 8 eps |Sigma_f32|); {card}")
    check(worst <= 0, f"quant8 {kind} off the float32 one beyond the "
          f"quant8 bound by {worst:.3e}")


def fetch_phase(torch, dt, cuda_lib, card: str, Y, L, noise) -> str:
    """The fetch at the north-star width on the float32 path: each
    fetch_dtype with Sigma assembled, float32 and quant8 packed too; the
    quant8 bound; the exports and their round trip.  Returns the quant8
    Sigma's digest."""
    import shutil
    import tempfile

    from dcfm_tpu_torch.serve.artifact import PosteriorArtifact
    label0, model, backend, kernels = FIT_PATHS[0]
    runs = {}
    for mode, materialize in (("float32", "auto"), ("bfloat16", "auto"),
                              ("float16", "auto"), ("quant8", "auto"),
                              ("float32", "never"), ("quant8", "never")):
        cfg = dataclasses.replace(
            path_config(dt, model, backend | {"fetch_dtype": mode}),
            materialize_sigma=materialize)
        res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
        label = f"{label0}, fetch {mode}, materialize_sigma={materialize}"
        ph = res.phase_seconds
        say(f"fetch [{mode}, {materialize}]: fetch_s {ph['fetch_s']:.4f}, "
            f"exposed_fetch_s {ph['exposed_fetch_s']:.4f}, assemble_s "
            f"{ph['assemble_s']:.4f}, link {link_bytes(res)} bytes, wall "
            f"{wall:.3f} s; {card}")
        err = check_fit(torch, res, launches, label, kernels, Y, L, noise)
        check((res.Sigma is None) == (materialize == "never")
              and (err is None) == (res.Sigma is None),
              f"[{label}] Sigma is {type(res.Sigma).__name__}")
        runs[mode, materialize] = res
    f32 = runs["float32", "auto"]
    for mode in ("bfloat16", "float16"):
        d = np.abs(runs[mode, "auto"].Sigma - f32.Sigma)
        say(f"fetch {mode} vs float32 Sigma: max |diff| {d.max():.4e}, "
            f"max rel {float((d / np.maximum(np.abs(f32.Sigma), 1e-30)).max()):.4e}")
    q8 = runs["quant8", "auto"]
    quant8_bound(torch, q8, f32, card)
    check(np.array_equal(runs["float32", "never"].upper_panels,
                         f32.upper_panels)
          and np.array_equal(runs["quant8", "never"]._q8_panels,
                             q8._q8_panels),
          "the packed fits' panels are not the assembled fits'")
    tmp = tempfile.mkdtemp(prefix="dcfm_artifact_")
    try:
        for key in (("quant8", "auto"), ("quant8", "never")):
            path = os.path.join(tmp, "_".join(key))
            t = time.perf_counter()
            runs[key].export_artifact(path)
            export_s = time.perf_counter() - t
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            t = time.perf_counter()
            back = PosteriorArtifact.open(path).assemble()
            say(f"export [{', '.join(key)}]: {export_s:.4f} s, {nbytes} "
                f"bytes; open + assemble {time.perf_counter() - t:.4f} s; "
                f"{card}")
            check(np.array_equal(back, q8.Sigma), f"[{key}] the artifact's "
                  "assembly is not the quant8 Sigma bit for bit")
            del back
    finally:
        shutil.rmtree(tmp)
    return sigma_digest(q8.Sigma)


# the checkpoint phase: the float32 path at the fits' width in chunks of
# 50 (8 boundaries over 400 iterations); the kills on 1,000 iterations, at
# the first file at iteration 200 or later
CKPT_CHUNK = 50
KILL_RUN = {"burnin": 200, "mcmc": 800}
KILL_AT = 200


def sigma_digest(S: np.ndarray) -> str:
    """sha256 of Sigma's float32 bytes: two fits agree bit for bit iff
    their digests do."""
    return hashlib.sha256(np.ascontiguousarray(S, np.float32)
                          .view(np.uint8)).hexdigest()


def ckpt_config(dt, label: str, run: dict | None = None, **fit_kw):
    """The path's fit config in chunks of CKPT_CHUNK, with ``run``'s
    changes and FitConfig fields ``fit_kw``."""
    _, model, backend, _ = next(p for p in FIT_PATHS if p[0] == label)
    cfg = path_config(dt, model, backend)
    return dataclasses.replace(cfg, run=dataclasses.replace(
        cfg.run, chunk_size=CKPT_CHUNK, **(run or {})), **fit_kw)


def rel_errors(torch, S: np.ndarray, Y, L, noise) -> tuple:
    """(rel. Frobenius error of S against the truth L L' + noise^2 I, the
    sample covariance's), on the card."""
    c = FIT
    dev = torch.device("cuda")
    Sd = torch.as_tensor(S, device=dev)
    Lt = torch.as_tensor(L, device=dev)
    St = Lt @ Lt.T + noise ** 2 * torch.eye(c["p"], device=dev)
    Yc = torch.as_tensor(Y, device=dev)
    Yc = Yc - Yc.mean(dim=0)
    Ss = Yc.T @ Yc / (c["n"] - 1)
    norm = torch.linalg.norm(St)
    return (float(torch.linalg.norm(Sd - St) / norm),
            float(torch.linalg.norm(Ss - St) / norm))


def state_digest(state) -> str:
    """sha256 of every state leaf's bytes, the column mask included."""
    from dcfm_tpu_torch.models.sampler import state_leaves
    h = hashlib.sha256()
    for t in state_leaves(state):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def scenario_model(dt, model, knobs: dict):
    """``model`` with the scenario knobs ``knobs`` (an ``adapt`` dict
    becomes an AdaptConfig)."""
    knobs = dict(knobs)
    if "adapt" in knobs:
        knobs["adapt"] = dt.AdaptConfig(**knobs["adapt"])
    return dataclasses.replace(model, **knobs)


def fit_child(spec: str) -> None:
    """``--fit-child SPEC``: one fit of ckpt_config(**SPEC) in this process
    on the script's synthetic data (SPEC's "k_true" overrides the data's
    rank, its "model" the scenario knobs, its "missing" the fraction of Y
    masked as missing, ``mcar``); prints one JSON line (Sigma's, the
    state's and Y_imputed's digests, phase seconds, executed iterations,
    rewinds, the elastic bookkeeping, the kernel launches, the effective
    ranks and the rel. Frobenius errors of Sigma and of the sample
    covariance).  SPEC's "backend" changes BackendConfig fields, and a
    "warm_start" dict among its "fit" fields is a WarmStart.  With SPEC's
    "export", the fit's own serve artifact is written there.  With SPEC's
    "rss_probe", the host-peak probe of step 14 (``rss_probe``)
    instead."""
    spec = json.loads(spec)
    if "rss_probe" in spec:
        rss_probe(spec)
        return
    import torch
    import dcfm_tpu_torch as dt
    check(torch.cuda.is_available(), "the fit child sees no CUDA device")
    c = FIT
    Y, L, noise = synthetic(c["n"], c["p"], spec.get("k_true", c["k_true"]))
    Yfit = mcar(Y, spec["missing"])[0] if "missing" in spec else Y
    fit_kw = dict(spec.get("fit", {}))
    if "warm_start" in fit_kw:
        from dcfm_tpu_torch.config import WarmStart
        fit_kw["warm_start"] = WarmStart(**fit_kw["warm_start"])
    cfg = ckpt_config(dt, spec["path"], spec.get("run"), **fit_kw)
    if "backend" in spec:
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, **spec["backend"]))
    if "model" in spec:
        cfg = dataclasses.replace(cfg, model=scenario_model(
            dt, cfg.model, spec["model"]))
    res = dt.fit(Yfit, cfg)
    err, err_sample = rel_errors(torch, res.Sigma, Y, L, noise)
    if "export" in spec:
        res.export_artifact(spec["export"])
    say(json.dumps({"sigma": sigma_digest(res.Sigma),
                    "state": state_digest(res.state),
                    "y_imputed": (None if res.Y_imputed is None
                                  else sigma_digest(res.Y_imputed)),
                    "phase_seconds": res.phase_seconds,
                    "executed": int(res.traces.shape[1]),
                    "rewinds": res.sentinel_rewinds,
                    "elastic_resume": res.elastic_resume,
                    "kernel_launches": res.kernel_launches,
                    "ranks": [res.stats.rank_min, res.stats.rank_mean,
                              res.stats.rank_max],
                    "err": err, "err_sample": err_sample,
                    "nonfinite": res.stats.nonfinite_count}))


def run_child(spec: dict, workdir: str, name: str, *, kill_at=None,
              path=None, timeout: float = 600.0) -> dict:
    """A fit in a fresh process (``--fit-child``).  With ``kill_at``, the
    child is SIGKILLed once the checkpoint at ``path`` says iteration >=
    kill_at (its meta is polled); returns that iteration.  Else returns
    the child's JSON line."""
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    out_path = os.path.join(workdir, name + ".out")
    with open(out_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--fit-child",
             json.dumps(spec)], stdout=out, stderr=subprocess.STDOUT)
        try:
            deadline = time.perf_counter() + timeout
            seen = -1
            while proc.poll() is None and time.perf_counter() < deadline:
                if kill_at is not None and os.path.exists(path):
                    try:
                        seen = int(read_checkpoint_meta(path)["iteration"])
                    except (OSError, ValueError, KeyError):
                        seen = -1
                    if seen >= kill_at:
                        proc.kill()
                        break
                time.sleep(0.005)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
    log = open(out_path).read()
    if kill_at is not None:
        check(proc.returncode == -signal.SIGKILL,
              f"[{name}] the child was not killed mid-run (exit "
              f"{proc.returncode}, file at {seen}): {log[-2000:]}")
        return {"killed_at": seen}
    check(proc.returncode == 0, f"[{name}] the fit child failed "
          f"({proc.returncode}): {log[-3000:]}")
    return json.loads(log.strip().splitlines()[-1])


class SaveLog:
    """Records every save of the chunk loop (file, iteration, light or
    full, bytes on disk, seconds in the writer's thread) and every join
    of the writer (the last is the final durability join): the script's
    instrumentation around runtime/pipeline, removed on exit."""

    def __init__(self):
        from dcfm_tpu_torch.runtime import pipeline
        self._pipeline = pipeline
        self.saves, self.joins = [], []

    def __enter__(self):
        p = self._pipeline
        self._save, self._writer = p.save_checkpoint, p.AsyncCheckpointWriter
        save, log = self._save, self

        def logged(path, leaves, cfg, **kw):
            t = time.perf_counter()
            save(path, leaves, cfg, **kw)
            log.saves.append({
                "file": os.path.basename(path),
                "iteration": int(np.asarray(leaves["iteration"])
                                 .reshape(-1)[0]),
                "light": bool(kw.get("state_only")),
                "bytes": os.path.getsize(path),
                "write_s": time.perf_counter() - t})

        class Writer(self._writer):
            def wait(self):
                t = time.perf_counter()
                try:
                    super().wait()
                finally:
                    log.joins.append(time.perf_counter() - t)

        p.save_checkpoint, p.AsyncCheckpointWriter = logged, Writer
        return self

    def __exit__(self, *exc):
        p = self._pipeline
        p.save_checkpoint, p.AsyncCheckpointWriter = self._save, self._writer


def poison_chain0(at: int):
    """The sentinel's test double: before the chunk that starts at global
    iteration ``at``, chain 0's Lambda becomes NaN (rebound, so a
    snapshot still reading the old tensor is untouched), once.  Returns
    the undo."""
    from dcfm_tpu_torch.models import sampler
    run_chunk = sampler.ChainRunner.run_chunk
    left = [1]

    def poisoned(self, c, carry, n):
        if c == 0 and carry.iteration == at and left[0]:
            left[0] -= 1
            carry.state = dataclasses.replace(
                carry.state, Lambda=carry.state.Lambda * float("nan"))
        return run_chunk(self, c, carry, n)

    sampler.ChainRunner.run_chunk = poisoned

    def undo():
        sampler.ChainRunner.run_chunk = run_chunk
    return undo


def ckpt_fit(torch, dt, cuda_lib, cfg, Y, label: str, card: str,
             log: SaveLog | None = None):
    """One in-process fit of the checkpoint phase, its peak memory and,
    under ``log``, its saves; prints one ``checkpoint`` line."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
    peak = torch.cuda.max_memory_allocated()
    ph = res.phase_seconds
    saves = "" if log is None else (
        f"; {len(log.saves)} saves at {[s['iteration'] for s in log.saves]}"
        f" ({sorted({(s['file'], s['bytes']) for s in log.saves})} bytes), "
        f"write_s {[round(s['write_s'], 4) for s in log.saves]}, final "
        f"join {log.joins[-1]:.4f} s" if log.joins else "")
    say(f"checkpoint [{label}]: wall {wall:.3f} s, chain_s "
        f"{ph['chain_s']:.4f}, checkpoint_s {ph['checkpoint_s']:.4f}, "
        f"init_s {ph['init_s']:.4f}, fetch_s {ph['fetch_s']:.4f}, "
        f"exposed_fetch_s {ph['exposed_fetch_s']:.4f}, executed "
        f"{res.traces.shape[1]}, peak allocated {peak} bytes{saves}; "
        f"sigma {sigma_digest(res.Sigma)[:16] if res.Sigma is not None else None}"
        f"; {card}")
    return res, launches


def checkpoint_phase(torch, dt, cuda_lib, card: str, Y, L, noise) -> None:
    """Checkpoint, resume, the sentinel and the streamed fetch at the
    north-star width: (a) the float32 path uninterrupted; (b) full saves
    at every boundary, Sigma bitwise (a), and the "auto" cadence; light
    saves; (e) a finished file resumed as a no-op; (f) the sentinel on a
    chain the script poisons: "abort" raises ChainDivergedError, "rewind"
    finishes with one rewind inside the quality rule; (g) quant8 streamed
    against post hoc, bitwise, at least one snapshot; then, on each path
    (f32, bf16, fused) over KILL_RUN: (c) a child SIGKILLed once its file
    reaches iteration KILL_AT, resumed in a fresh process: Sigma bitwise
    the uninterrupted fit's; and for f32 (d), as (c) in light mode with a
    full sidecar every 2nd save, the sidecar used."""
    import shutil
    import tempfile

    from dcfm_tpu_torch.resilience.sentinel import ChainDivergedError
    kernels = FIT_PATHS[0][3]
    total = FIT["burnin"] + FIT["mcmc"]
    work = tempfile.mkdtemp(prefix="dcfm_ckpt_")
    try:
        a, _ = ckpt_fit(torch, dt, cuda_lib, ckpt_config(dt, "f32"), Y,
                        "f32 (a) no checkpoint", card)
        ref = sigma_digest(a.Sigma)
        path = os.path.join(work, "b.npz")
        with SaveLog() as log:
            b, launches = ckpt_fit(
                torch, dt, cuda_lib,
                ckpt_config(dt, "f32", checkpoint_path=path,
                            checkpoint_every_chunks=1), Y,
                "f32 (b) full, every boundary", card, log)
        check_fit(torch, b, launches, "f32 (b)", kernels, Y, L, noise)
        check(sigma_digest(b.Sigma) == ref, "(b) checkpointing on changed "
              "Sigma's bits")
        # a save still in flight defers a due one to a later boundary
        # (the reference's policy): the first and the last boundary save
        its = [s["iteration"] for s in log.saves]
        check(its[0] == CKPT_CHUNK and its[-1] == total
              and its == sorted(set(its))
              and all(i % CKPT_CHUNK == 0 for i in its),
              f"(b) saves at {its}")
        for mode, every in (("full", "auto"), ("light", 1), ("light", "auto")):
            with SaveLog() as log:
                r, _ = ckpt_fit(torch, dt, cuda_lib, ckpt_config(
                    dt, "f32", checkpoint_path=os.path.join(
                        work, f"{mode}_{every}.npz"), checkpoint_mode=mode,
                    checkpoint_every_chunks=every), Y,
                    f"f32 {mode}, every {every}", card, log)
            check(sigma_digest(r.Sigma) == ref, f"[{mode}, {every}] "
                  "checkpointing on changed Sigma's bits")
            check(log.saves and log.saves[-1]["iteration"] == total,
                  f"[{mode}, {every}] the last boundary did not save")
            del r
        # (e) the finished full file from (b), resumed: a no-op
        e, _ = ckpt_fit(torch, dt, cuda_lib, ckpt_config(
            dt, "f32", checkpoint_path=path, resume=True), Y,
            "f32 (e) finished file resumed", card)
        check(sigma_digest(e.Sigma) == ref and e.traces.shape[1] == 0,
              "(e) the no-op resume is not the finished fit")
        del b, e
        # (f) the sentinel on a chain poisoned at iteration 200
        undo = poison_chain0(total // 2)
        try:
            try:
                dt.fit(Y, ckpt_config(dt, "f32", sentinel="abort"))
                fail("(f) sentinel='abort' let a poisoned chain finish")
            except ChainDivergedError as err:
                check(err.iteration == total // 2 + CKPT_CHUNK,
                      f"(f) diverged at {err.iteration}")
                say(f"sentinel [abort]: ChainDivergedError at iteration "
                    f"{err.iteration} (poisoned before {total // 2})")
        finally:
            undo()
        undo = poison_chain0(total // 2)
        try:
            f, _ = ckpt_fit(torch, dt, cuda_lib, ckpt_config(
                dt, "f32", checkpoint_path=os.path.join(work, "f.npz"),
                checkpoint_every_chunks=1, sentinel="rewind"), Y,
                "f32 (f) sentinel rewind", card)
        finally:
            undo()
        check(f.sentinel_rewinds == 1, f"(f) {f.sentinel_rewinds} rewinds")
        err = check_quality(torch, f, "f32 (f) rewound", Y, L, noise)
        say(f"sentinel [rewind]: {f.sentinel_rewinds} rewind, rel Frobenius "
            f"error {err:.6f}, graphs {json.dumps(f.graphs)}; {card}")
        del f
        # (g) quant8, streamed against post hoc
        got = {}
        for stream in ("off", "auto"):
            cfg = ckpt_config(dt, "f32")
            cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
                cfg.backend, fetch_dtype="quant8", fetch_stream=stream))
            got[stream], _ = ckpt_fit(torch, dt, cuda_lib, cfg, Y,
                                      f"f32 (g) quant8, stream {stream}",
                                      card)
        st = got["auto"].stream_stats
        check(st is not None and st["snapshots"] > 0, f"(g) the streamed "
              f"fit did not stream: {st}")
        check(got["off"].stream_stats is None, "(g) 'off' streamed")
        check(sigma_digest(got["auto"].Sigma) == sigma_digest(
            got["off"].Sigma) and np.array_equal(
                got["auto"]._q8_panels, got["off"]._q8_panels)
              and np.array_equal(got["auto"]._q8_scales,
                                 got["off"]._q8_scales),
              "(g) the streamed quant8 panels are not the post-hoc ones")
        say(f"stream [quant8]: snapshots {st['snapshots']}, skipped "
            f"{st['skipped']}, streamed fetch_s "
            f"{got['auto'].phase_seconds['fetch_s']:.4f} exposed "
            f"{got['auto'].phase_seconds['exposed_fetch_s']:.4f}, post-hoc "
            f"fetch_s {got['off'].phase_seconds['fetch_s']:.4f}, drains "
            f"{[round(x, 4) for x in st['chunk_fetch_s']]}; {card}")
        del got
        # (c), (d) and (c) on bf16 and fused, on KILL_RUN's longer chain:
        # a full save (~420 MB) takes about as long as the 400-iteration
        # chain, so there a kill at iteration >= 200 would land after the
        # last save
        for label in ("f32", "bf16", "fused"):
            r, _ = ckpt_fit(torch, dt, cuda_lib,
                            ckpt_config(dt, label, KILL_RUN), Y,
                            f"{label} (a) no checkpoint, "
                            f"{sum(KILL_RUN.values())} iterations", card)
            ref = sigma_digest(r.Sigma)
            del r
            kill_resume(dt, label, {}, ref, work, "full", card)
            if label == "f32":
                kill_resume(dt, label, {"checkpoint_mode": "light",
                                        "checkpoint_full_every": 2},
                            ref, work, "light", card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def kill_resume(dt, label: str, fit_kw: dict, ref: str, work: str,
                tag: str, card: str) -> None:
    """(c)/(d): a child fit of KILL_RUN with a checkpoint at every
    boundary, SIGKILLed once its file is at iteration KILL_AT or more;
    then resume=True in a fresh process: Sigma bitwise ``ref``.  A light
    file with a full sidecar must resume from the sidecar."""
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    total = sum(KILL_RUN.values())
    path = os.path.join(work, f"{label}_{tag}.npz")
    spec = {"path": label, "run": KILL_RUN,
            "fit": {"checkpoint_path": path, "checkpoint_every_chunks": 1,
                    **fit_kw}}
    t = time.perf_counter()
    killed = run_child(spec, work, f"{label}_{tag}_killed",
                       kill_at=KILL_AT, path=path)["killed_at"]
    kill_s = time.perf_counter() - t
    meta = read_checkpoint_meta(path)
    check(meta["iteration"] < total, f"[{label} {tag}] the file reached the "
          f"end ({meta['iteration']}) before the kill")
    side = path + ".full"
    side_it = (read_checkpoint_meta(side)["iteration"]
               if os.path.exists(side) else None)
    t = time.perf_counter()
    out = run_child(dict(spec, fit=dict(spec["fit"], resume=True)), work,
                    f"{label}_{tag}_resumed")
    resume_s = time.perf_counter() - t
    say(f"kill [{label}, {tag}]: killed with the file at iteration "
        f"{killed} ({kill_s:.1f} s child wall), light file "
        f"{meta.get('state_only')}, sidecar at {side_it}; resumed in a "
        f"fresh process ({resume_s:.1f} s wall): executed "
        f"{out['executed']}, init_s (the load) "
        f"{out['phase_seconds']['init_s']:.4f}, checkpoint_s "
        f"{out['phase_seconds']['checkpoint_s']:.4f}; Sigma "
        f"{'=' if out['sigma'] == ref else '!='} uninterrupted; {card}")
    check(out["sigma"] == ref, f"[{label} {tag}] the resumed fit's Sigma is "
          "not the uninterrupted fit's bits")
    if fit_kw.get("checkpoint_mode") == "light":
        check(meta.get("state_only") and side_it is not None
              and out["executed"] == total - side_it,
              f"[{label} {tag}] the resume did not take the sidecar (light "
              f"{meta.get('state_only')}, sidecar {side_it}, executed "
              f"{out['executed']})")
    else:
        check(out["executed"] == total - meta["iteration"],
              f"[{label} {tag}] resumed from the wrong iteration")


def sd_config(dt, fetch_dtype: str = "float32", **fit_kw):
    """The float32 path with ModelConfig.posterior_sd (and ``fit_kw``'s
    FitConfig fields), in chunks of CKPT_CHUNK."""
    cfg = ckpt_config(dt, "f32", **fit_kw)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, posterior_sd=True),
        backend=dataclasses.replace(cfg.backend, fetch_dtype=fetch_dtype))


def sd_phase(torch, dt, cuda_lib, card: str, Y, L, noise,
             f32_digest: str) -> None:
    """(8) The posterior SD on the float32 path: graph == eager with the
    second moment; fits under fetch_dtype float32 and quant8 (each after a
    4-sweep warm-up), their launches, Sigma bitwise the fit without SD,
    the SD finite and non-negative, the quant8 SD within its bound; chain
    iterations/s, peak allocated, device busy per sweep."""
    label0, model, backend, kernels = FIT_PATHS[0]
    sd_model = model | {"posterior_sd": True}
    graph_equality_phase(torch, cuda_lib, path_config(dt, sd_model, backend),
                         Y, card, "f32 posterior_sd", 8)
    c = FIT
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    runs = {}
    for mode in ("float32", "quant8"):
        cfg = path_config(dt, sd_model, backend | {"fetch_dtype": mode})
        dt.fit(Y, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2,
                                                            mcmc=2)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
        peak = torch.cuda.max_memory_allocated()
        label = f"{label0} posterior_sd, fetch {mode}"
        ph = res.phase_seconds
        say(f"sd [{mode}]: {sweeps} sweeps in {ph['chain_s']:.3f} s chain "
            f"time = {sweeps / ph['chain_s']:.2f} chain iterations/s (wall "
            f"{wall:.3f} s), fetch_s {ph['fetch_s']:.4f}, exposed_fetch_s "
            f"{ph['exposed_fetch_s']:.4f}, assemble_s "
            f"{ph['assemble_s']:.4f}, link {link_bytes(res)} bytes of mean "
            f"panels and as many of SD panels, peak allocated {peak} bytes "
            f"({peak / 2**30:.3f} GiB); {card}")
        check_fit(torch, res, launches, label, kernels, Y, L, noise)
        SD = res.Sigma_sd
        check(SD is not None and SD.shape == (c["p"], c["p"])
              and bool(np.isfinite(SD).all()) and bool((SD >= 0).all()),
              f"[{label}] Sigma_sd is not finite and non-negative")
        say(f"sd [{mode}]: Sigma_sd max {float(SD.max()):.4e}, mean "
            f"{float(SD.mean()):.4e}, diagonal mean "
            f"{float(np.diag(SD).mean()):.4e}")
        if mode == "float32":
            check(sigma_digest(res.Sigma) == f32_digest, "[posterior_sd] "
                  "the SD changed the mean's bits (Sigma != the f32 fit's)")
        runs[mode] = res
    quant8_bound(torch, runs["quant8"], runs["float32"], card, kind="sd")
    sweep_profile(torch, path_config(dt, sd_model, backend), Y, card,
                  "f32 posterior_sd")


def same_artifact(a_path: str, b_path: str, sd: bool) -> None:
    """Two artifacts' panels, per-panel scales, maps and CRCs byte for
    byte (meta.json's provenance names each one's source)."""
    from dcfm_tpu_torch.serve.artifact import PosteriorArtifact
    a, b = PosteriorArtifact.open(a_path), PosteriorArtifact.open(b_path)
    for name in ("mean_q8.bin",) + (("sd_q8.bin",) if sd else ()):
        with open(os.path.join(a_path, name), "rb") as x, \
                open(os.path.join(b_path, name), "rb") as y:
            check(x.read() == y.read(), f"{name} differs between "
                  f"{a_path} and {b_path}")
    check(a.meta["panel_crc"] == b.meta["panel_crc"], "panel CRCs differ")
    with np.load(os.path.join(a_path, "maps.npz")) as x, \
            np.load(os.path.join(b_path, "maps.npz")) as y:
        check(sorted(x.files) == sorted(y.files)
              and all(x[k].tobytes() == y[k].tobytes() for k in x.files),
              "maps.npz differs")


def sd_within_a_step(a, b) -> float:
    """Max |SD_a - SD_b| over the dequantized SD panels of two artifacts,
    in int8 steps (scale/127 of the panel); checked <= 1."""
    da = a.sd_panels.astype(np.float32) * (a.sd_scale / 127)[:, None, None]
    db = b.sd_panels.astype(np.float32) * (b.sd_scale / 127)[:, None, None]
    step = np.maximum(a.sd_scale, b.sd_scale)[:, None, None] / 127
    steps = float((np.abs(da - db) / np.maximum(step, 1e-30)).max())
    check(steps <= 1 + 1e-5, f"SD panels {steps:.3f} steps apart")
    return steps


def export_phase(torch, dt, cuda_lib, card: str, Y, work: str) -> None:
    """(9) export_from_checkpoint of the SD fit's full file and of a light
    file read through its .full sidecar, against the fit's own
    export_artifact: mean panels and scales byte for byte, SD within one
    int8 step."""
    import shutil

    from dcfm_tpu_torch.serve.artifact import export_from_checkpoint
    full = os.path.join(work, "sd_full.npz")
    with SaveLog() as log:
        res, _ = ckpt_fit(torch, dt, cuda_lib, sd_config(
            dt, checkpoint_path=full), Y, "f32 posterior_sd, full saves",
            card, log)
    light = os.path.join(work, "sd_light.npz")
    ckpt_fit(torch, dt, cuda_lib, sd_config(
        dt, checkpoint_path=light, checkpoint_mode="light"), Y,
        "f32 posterior_sd, light saves", card)
    shutil.copy(full, light + ".full")        # the sidecar: the final sums
    own = res.export_artifact(os.path.join(work, "own"))
    for tag, path in (("full", full), ("light + sidecar", light)):
        t = time.perf_counter()
        art = export_from_checkpoint(path, Y, os.path.join(work, "x_" +
                                                           tag[:5]))
        secs = time.perf_counter() - t
        check(art.mean_panels.tobytes() == own.mean_panels.tobytes()
              and art.mean_scale.tobytes() == own.mean_scale.tobytes(),
              f"[export {tag}] mean panels are not the fit's own export")
        steps = sd_within_a_step(art, own)
        say(f"export from checkpoint [{tag}]: {secs:.3f} s for a "
            f"{os.path.getsize(path if tag == 'full' else path + '.full')}"
            f"-byte file; mean panels = the fit's export byte for byte, SD "
            f"within {steps:.3f} int8 steps ({int((art.sd_panels != own.sd_panels).sum())} "
            f"of {art.sd_panels.size} entries differ); {card}")
    del res


def stream_artifact_phase(torch, dt, cuda_lib, card: str, Y,
                          work: str) -> None:
    """(10) A quant8 SD fit streamed into the serve artifact against the
    post-hoc export of the same chain, byte for byte."""
    art = os.path.join(work, "streamed")
    streamed, _ = ckpt_fit(torch, dt, cuda_lib, sd_config(
        dt, "quant8", stream_artifact=art), Y,
        "f32 posterior_sd quant8, stream_artifact", card)
    st = streamed.stream_stats
    check(streamed.artifact_path == art and st is not None
          and st["snapshots"] > 0, f"(10) nothing streamed: {st}")
    cfg = sd_config(dt, "quant8")
    post, _ = ckpt_fit(torch, dt, cuda_lib, dataclasses.replace(
        cfg, backend=dataclasses.replace(cfg.backend, fetch_stream="off")),
        Y, "f32 posterior_sd quant8, post hoc", card)
    t = time.perf_counter()
    post.export_artifact(os.path.join(work, "post"))
    export_s = time.perf_counter() - t
    same_artifact(art, os.path.join(work, "post"), True)
    say(f"stream_artifact: snapshots {st['snapshots']}, skipped "
        f"{st['skipped']}, exposed_fetch_s "
        f"{streamed.phase_seconds['exposed_fetch_s']:.4f} (post hoc: fetch "
        f"exposed {post.phase_seconds['exposed_fetch_s']:.4f} s + export "
        f"{export_s:.4f} s); panels, scales, maps and CRCs = the post-hoc "
        f"export byte for byte; {card}")


def elastic_phase(dt, card: str, work: str) -> None:
    """(11) A 2-chain float32 child over KILL_RUN SIGKILLed once its full
    file is at KILL_AT or more, resumed at 1 and at 3 chains in fresh
    processes: the adoption, its divisor, the kernels once per executed
    sweep, Sigma inside the quality rule."""
    import shutil

    from dcfm_tpu_torch.runtime.fetch import accumulator_window
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    run = dict(KILL_RUN)
    total = sum(run.values())
    path = os.path.join(work, "elastic.npz")
    spec = {"path": "f32", "run": run,
            "fit": {"checkpoint_path": path, "checkpoint_every_chunks": 1}}
    killed = run_child(spec, work, "elastic_killed", kill_at=KILL_AT,
                       path=path)["killed_at"]
    meta = read_checkpoint_meta(path)
    check(not meta["state_only"] and meta["iteration"] < total,
          f"(11) the killed file: {meta['iteration']}")
    for to in (1, 3):
        mine = os.path.join(work, f"elastic_{to}.npz")
        shutil.copy(path, mine)
        t = time.perf_counter()
        out = run_child({"path": "f32", "run": run | {"num_chains": to},
                         "fit": {"checkpoint_path": mine, "resume": True,
                                 "checkpoint_every_chunks": 1}},
                        work, f"elastic_to_{to}")
        wall = time.perf_counter() - t
        el = out["elastic_resume"]
        check(el is not None and (el["from_chains"], el["to_chains"])
              == (2, to), f"(11) to {to}: {el}")
        _, inv, bessel = accumulator_window(
            total, run["burnin"], FIT["thin"], min(el["chain_acc_starts"]),
            to, el["chain_acc_starts"], el["fold_draws"])
        sweeps = to * out["executed"]
        check(out["executed"] == total - meta["iteration"],
              f"(11) to {to}: resumed from the wrong iteration")
        for name, count in out["kernel_launches"].items():
            want = sweeps if name in FIT_PATHS[0][3] else 0
            check(count == want, f"(11) to {to}: {name} launched {count} "
                  f"times in {sweeps} sweeps")
        check(out["nonfinite"] == 0, f"(11) to {to}: non-finite state")
        say(f"elastic [2 -> {to}]: killed with the file at {killed} (meta "
            f"{meta['iteration']}), resumed in a fresh process ({wall:.1f} "
            f"s wall, init_s {out['phase_seconds']['init_s']:.4f}): "
            f"kept {el['kept']}, dropped {el['dropped']}, birthed "
            f"{el['birthed']}, fold_draws {el['fold_draws']}, "
            f"chain_acc_starts {el['chain_acc_starts']}, lineage "
            f"{el['elastic_lineage']}, divisor inv_count {float(inv):.9g} "
            f"(bessel {float(bessel):.9g}), launches "
            f"{json.dumps(out['kernel_launches'])}; rel Frobenius error "
            f"{out['err']:.6f} (sample covariance {out['err_sample']:.6f});"
            f" {card}")
        check(out["err"] < 0.25 and out["err"] <= 2 * out["err_sample"],
              f"(11) to {to}: rel Frobenius error {out['err']:.4f} outside "
              "the quality rule")


# ---------------------------------------------------------------------------
# (12) the scenarios: the horseshoe and Dirichlet-Laplace priors and
# adaptive rank truncation
# ---------------------------------------------------------------------------

# (label, ModelConfig knobs, the kernels that launch once per sweep)
SCEN_PATHS = (
    ("dl", {"prior": "dl", "lambda_kernel": "pallas"},
     ("chol_sample", "sse_ps")),
    ("horseshoe+adapt", {"prior": "horseshoe", "rank_adapt": True,
                         "lambda_kernel": "pallas"},
     ("chol_sample", "sse_ps")),
    ("mgp+adapt", {"rank_adapt": True, "lambda_kernel": "pallas"},
     ("chol_sample", "sse_ps")),
    ("horseshoe+adapt fused", {"prior": "horseshoe", "rank_adapt": True,
                               "lambda_kernel": "pallas-fused"},
     ("lam_update", "sse_ps")),
)
# BASELINE.json config 5, "adaptive rank truncation + horseshoe, p=50000,
# 256 shards (pod-scale)", at scripts/run_baseline_configs.py's full width
# (P = 196 per shard) on one card; synthetic data of true rank 4 so the
# truncation has columns to prune; the fits' schedule
CONFIG5 = dict(p=256 * 196, n=500, k_true=4, g=256, K=8, rho=0.9, chains=2,
               burnin=200, mcmc=200, thin=2)
# the scenario kill: 600 burn-in iterations, so a file at KILL_AT or a few
# deferred saves later is mid-burn-in, while the mask still adapts
SCEN_KILL_RUN = {"burnin": 600, "mcmc": 400}
# the adaptation thresholds of the rank_adapt paths: at the defaults (a
# column is redundant when 95% of its |loadings| are below 0.05) neither
# package prunes a column of this true-rank-4 data in 200 burn-in sweeps;
# at these, both prune to about the true rank
SCEN_ADAPT = {"eps": 0.1, "prop": 0.8}


def blockwise_errors(torch, res, Y, L, noise, batch: int = 1024,
                     dev: str = "cuda") -> tuple:
    """(rel. Frobenius error of the fit's posterior mean against the truth
    L L' + noise^2 I, the sample covariance's), summed block by block on
    the card from ``FitResult.sigma_block`` - no (p, p) matrix is formed.
    Blocks are in shard coordinates (the norms are permutation-invariant);
    an off-diagonal pair counts twice, padding columns not at all."""
    pre = res.preprocess
    g, P = pre.num_shards, pre.shard_size
    n = Y.shape[0]
    check(pre.zero_cols.size == 0, "blockwise quality needs no zero columns")
    dev = torch.device(dev)
    p_kept = pre.p_used - pre.n_pad
    real = pre.perm < p_kept                  # shard position -> not padding
    cols = pre.kept_cols[np.where(real, pre.perm, 0)]   # -> caller column
    mask = torch.as_tensor(real.reshape(g, P), device=dev,
                           dtype=torch.float32)
    Lp = torch.as_tensor(L[cols], device=dev).reshape(g, P, -1)
    Yc = torch.as_tensor(Y[:, cols], device=dev)
    Yc = Yc - Yc.mean(dim=0)
    Ys = Yc.T.reshape(g, P, n).contiguous()
    del Yc
    eye = torch.eye(P, device=dev)
    rows, colq = np.triu_indices(g)
    sums = torch.zeros(3, dtype=torch.float64, device=dev)
    for a in range(0, rows.size, batch):
        r, c = rows[a:a + batch], colq[a:a + batch]
        B = torch.as_tensor(np.stack([res.sigma_block(int(i), int(j))
                                      for i, j in zip(r, c)]), device=dev)
        rt = torch.as_tensor(r, device=dev)
        ct = torch.as_tensor(c, device=dev)
        diag = (rt == ct)
        T = Lp[rt] @ Lp[ct].mT + (noise ** 2) * eye * diag[:, None, None]
        S = Ys[rt] @ Ys[ct].mT / (n - 1)
        w = (torch.where(diag, 1.0, 2.0)[:, None, None]
             * mask[rt][:, :, None] * mask[ct][:, None, :])
        sums += torch.stack([(w * (B - T) ** 2).double().sum(),
                             (w * (S - T) ** 2).double().sum(),
                             (w * T ** 2).double().sum()])
    err2, samp2, tru2 = sums.tolist()
    return math.sqrt(err2 / tru2), math.sqrt(samp2 / tru2)


def prior_update_profile(torch, cfg, Y, card: str, label: str,
                         sweep_busy_ms=None) -> float:
    """Device time of one prior update at the chain's width, on chain 0's
    state after 24 sweeps, its variates pre-drawn (the update alone, as the
    graph runs it; for DL the GIG's 64 rounds of uniforms among them), and
    the device time of drawing them (noise.draw_into, outside the graph);
    with ``sweep_busy_ms`` its share of the sweep's device time."""
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import (
        BufferedDraws, RecordingDraws, TorchNoise, draw_into)
    m, Yd, prior = chain_setup(torch, cfg, Y)
    runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=0,
                         thin=4, unroll=1)
    carry = runner.init_chain(0)
    runner.run_chunk(0, carry, 24)
    st = carry.state
    noise = TorchNoise(5, "cuda")
    recipe: list = []
    prior.update(RecordingDraws(noise.sweep(0, 0), recipe), st.prior,
                 st.Lambda, st.active)
    slots = [torch.empty(call.shape, device="cuda") for call in recipe]

    def draw():
        draw_into(noise.sweep(0, 1), recipe, slots)

    def update():
        prior.update(BufferedDraws(recipe, slots), st.prior, st.Lambda,
                     st.active)

    draw()
    upd, drw = device_ms(update, 20), device_ms(draw, 20)
    nbytes = sum(4 * t.numel() for t in slots)
    share = ("" if not sweep_busy_ms else
             f", {upd / sweep_busy_ms:.1%} of the sweep's device busy "
             f"{sweep_busy_ms:.3f} ms")
    say(f"prior update [{label}]: {upd * 1e3:.2f} us of device time per "
        f"sweep{share}; its {len(recipe)} pre-drawn calls hold {nbytes} "
        f"bytes, drawn outside the graph in {drw * 1e3:.2f} us of device "
        f"time; {card}")
    del runner, carry
    torch.cuda.empty_cache()
    return upd


def config5_config(dt, **model):
    """Step 12(c)'s fit config of BASELINE config 5 (ModelConfig knobs
    ``model`` on top)."""
    c = CONFIG5
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=c["g"], factors_per_shard=c["K"],
                             rho=c["rho"], prior="horseshoe",
                             rank_adapt=True, lambda_kernel="pallas",
                             adapt=dt.AdaptConfig(**SCEN_ADAPT), **model),
        run=dt.RunConfig(burnin=c["burnin"], mcmc=c["mcmc"], thin=c["thin"],
                         seed=0, num_chains=c["chains"]),
        backend=dt.BackendConfig(sse_mode="auto", fetch_dtype="quant8"),
        materialize_sigma="never")


def q8_digest(res) -> str:
    """sha256 of a quant8 fit's int8 panels and per-panel scales: two fits
    hold the same panels bit for bit iff their digests agree."""
    h = hashlib.sha256(np.ascontiguousarray(res._q8_panels).view(np.uint8))
    h.update(np.ascontiguousarray(res._q8_scales, np.float32).tobytes())
    return h.hexdigest()


def config5_phase(torch, dt, cuda_lib, k1, k5, card: str) -> tuple:
    """(12c) BASELINE config 5 on one card: horseshoe + rank_adapt at g =
    256, P = 196, p = 50,176, quant8 and no dense Sigma; K1 and K5 at its
    batch against their plain versions, the memory reckoned before the
    fit and measured, 800 launches of each, the quality rule block by
    block on the card, the effective ranks, chain iterations/s, device
    busy per sweep.  Returns the fit's launches and its reference for step
    14 (the int8 panels' digest, the phase seconds, the peak)."""
    from dcfm_tpu_torch.models.state import num_padded_pairs
    c = CONFIG5
    g, K, P = c["g"], c["K"], c["p"] // c["g"]
    B = g * P
    t = time.perf_counter()
    Y5, L5, noise = synthetic(c["n"], c["p"], c["k_true"])
    say(f"config 5: synthetic data ({c['n']} x {c['p']}, true rank "
        f"{c['k_true']}) in {time.perf_counter() - t:.1f} s")
    rng = np.random.default_rng(55)
    dev = torch.device("cuda")
    args = [torch.as_tensor(spd(rng.standard_normal((B, K, K), np.float32)),
                            device=dev)]
    args += [torch.as_tensor(rng.standard_normal((B, K), np.float32),
                             device=dev) for _ in range(2)]
    compare(torch, f"K1 chol_sample (config 5) B={B} K={K}",
            k1.chol_sample(*args), k1.chol_sample_plain(*args))
    ops = sse_operands(torch, rng, B, K)
    k5_compare(torch, "K5 sse_ps (config 5)", k5.sse_ps(*ops, bs=0.3), ops,
               0.3)
    del args, ops
    Qp = num_padded_pairs(g)
    acc = Qp * P * P * 4
    n_pairs = g * (g + 1) // 2
    reckon = 4 * acc + 2 * n_pairs * P * P * 4
    say(f"config 5 memory, reckoned: one packed accumulator {Qp} panels x "
        f"{P}^2 x 4 B = {acc} bytes ({Qp * P * P} elements, "
        f"{'under' if Qp * P * P < 2 ** 31 else 'OVER'} 2^31); in the "
        f"chain the static carry's, two chains' and the per-draw panel "
        f"temporary: {4 * acc} bytes; at the last boundary the streamed "
        f"fetch's chain sum takes the temporary's place and the quant8 "
        f"cast adds two float32 temporaries of the {n_pairs} kept panels "
        f"({2 * n_pairs * P * P * 4} bytes): peak ~{reckon} bytes")
    cfg = config5_config(dt)
    dt.fit(Y5, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2,
                                                          mcmc=2)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y5)
    peak = torch.cuda.max_memory_allocated()
    ph = res.phase_seconds
    ref = {"q8": q8_digest(res), "phase": ph, "peak": peak}
    say(f"config 5 int8 panels and scales sha256 {ref['q8']}")
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    say(f"config 5 fit: {sweeps} sweeps in {ph['chain_s']:.3f} s chain "
        f"time = {sweeps / ph['chain_s']:.2f} chain iterations/s (wall "
        f"{wall:.3f} s); fetch_s {ph['fetch_s']:.4f}, exposed_fetch_s "
        f"{ph['exposed_fetch_s']:.4f}; peak allocated {peak} bytes "
        f"({peak / 2**30:.3f} GiB, reckoned ~{reckon}); {card}")
    say("config 5 phase_seconds: " + json.dumps(ph))
    say(f"config 5 graphs: {json.dumps(res.graphs)}; stream "
        f"{json.dumps(res.stream_stats)}")
    say(f"config 5 kernel launches: {json.dumps(launches)} (expected "
        f"{sweeps} for chol_sample and sse_ps at B = {B}, 0 for the "
        "others)")
    for name, count in launches.items():
        want = sweeps if name in ("chol_sample", "sse_ps") else 0
        check(count == want, f"[config 5] {name} launched {count} times in "
              f"{sweeps} sweeps, expected {want}")
    check(res.Sigma is None and res.graphs["replays"] > 0,
          "[config 5] a dense Sigma was formed, or no graph ran")
    check(res.stats.nonfinite_count == 0 and res.stats.acc_nonfinite == 0,
          f"[config 5] chain health: {res.stats}")
    t = time.perf_counter()
    err, err_s = blockwise_errors(torch, res, Y5, L5, noise)
    say(f"config 5 rel Frobenius error vs truth (block by block on the "
        f"card, {time.perf_counter() - t:.1f} s): {err:.6f} (sample "
        f"covariance: {err_s:.6f}); effective rank min / mean / max "
        f"{res.stats.rank_min:g} / {res.stats.rank_mean:.4f} / "
        f"{res.stats.rank_max:g} of K = {K}; {card}")
    check(err < 0.25 and err <= 2 * err_s, f"[config 5] rel Frobenius "
          f"error {err:.4f} outside the quality rule (sample {err_s:.4f})")
    check(1 <= res.stats.rank_min <= res.stats.rank_max <= K,
          f"[config 5] ranks {res.stats}")
    del res
    torch.cuda.empty_cache()
    sweep_profile(torch, cfg, Y5, card, "config 5 horseshoe+adapt")
    return launches, ref


def scenario_kill_phase(torch, dt, cuda_lib, card: str, Y4, work: str
                        ) -> None:
    """(12d) horseshoe + rank_adapt over SCEN_KILL_RUN at the north-star
    width: a child SIGKILLed once its file is at KILL_AT or more (mid
    burn-in), resumed in a fresh process: Sigma and every state leaf, the
    mask included, bitwise the uninterrupted fit's; then
    export_from_checkpoint of its finished file is the resumed fit's own
    export byte for byte."""
    from dcfm_tpu_torch.serve.artifact import (
        PosteriorArtifact, export_from_checkpoint)
    from dcfm_tpu_torch.utils.checkpoint import (
        carry_template, load_checkpoint, read_checkpoint_meta)
    knobs = {"prior": "horseshoe", "rank_adapt": True, "adapt": SCEN_ADAPT}
    cfg = ckpt_config(dt, "f32", SCEN_KILL_RUN)
    cfg = dataclasses.replace(cfg, model=scenario_model(dt, cfg.model,
                                                         knobs))
    ref, _ = ckpt_fit(torch, dt, cuda_lib, cfg, Y4,
                      "horseshoe+adapt (a) no checkpoint, "
                      f"{sum(SCEN_KILL_RUN.values())} iterations", card)
    ref_sigma, ref_state = sigma_digest(ref.Sigma), state_digest(ref.state)
    del ref
    path = os.path.join(work, "hs_adapt.npz")
    spec = {"path": "f32", "run": SCEN_KILL_RUN, "model": knobs,
            "k_true": 4, "fit": {"checkpoint_path": path,
                                 "checkpoint_every_chunks": 1}}
    killed = run_child(spec, work, "hs_adapt_killed", kill_at=KILL_AT,
                       path=path)["killed_at"]
    meta = read_checkpoint_meta(path)
    check(meta["iteration"] < SCEN_KILL_RUN["burnin"],
          f"[horseshoe+adapt] the file is at {meta['iteration']}, not mid "
          "burn-in")
    c = FIT
    active = load_checkpoint(path, carry_template(
        cfg.model, n=c["n"], P=-(-c["p"] // c["g"]),
        num_chains=c["chains"]))[0]["active"]
    art_fit = os.path.join(work, "hs_fit_art")
    t = time.perf_counter()
    out = run_child(dict(spec, fit=dict(spec["fit"], resume=True),
                         export=art_fit), work, "hs_adapt_resumed")
    resume_s = time.perf_counter() - t
    say(f"kill [horseshoe+adapt]: killed with the file at iteration "
        f"{killed} (meta {meta['iteration']}, burn-in "
        f"{SCEN_KILL_RUN['burnin']}), active columns per chain there "
        f"{active.reshape(active.shape[0], -1).sum(-1).tolist()}; resumed "
        f"in a fresh process ({resume_s:.1f} s wall): executed "
        f"{out['executed']}, init_s {out['phase_seconds']['init_s']:.4f}, "
        f"ranks {out['ranks']}; Sigma "
        f"{'=' if out['sigma'] == ref_sigma else '!='} uninterrupted, "
        f"state (mask included) "
        f"{'=' if out['state'] == ref_state else '!='} uninterrupted; "
        f"{card}")
    check(out["sigma"] == ref_sigma and out["state"] == ref_state,
          "[horseshoe+adapt] the resumed fit is not the uninterrupted fit's "
          "bits")
    check(out["executed"] == sum(SCEN_KILL_RUN.values()) - meta["iteration"],
          "[horseshoe+adapt] resumed from the wrong iteration")
    art_ck = os.path.join(work, "hs_ck_art")
    t = time.perf_counter()
    export_from_checkpoint(path, Y4, art_ck)
    export_s = time.perf_counter() - t
    def mean_bytes(path):
        scales = PosteriorArtifact.open(path).panels("mean")[1]
        with open(os.path.join(path, "mean_q8.bin"), "rb") as f:
            return f.read(), np.asarray(scales).tobytes()

    same = mean_bytes(art_fit) == mean_bytes(art_ck)
    say(f"export from checkpoint [horseshoe+adapt]: {export_s:.3f} s; mean "
        f"panels and scales {'=' if same else '!='} the resumed fit's own "
        f"export; {card}")
    check(same, "[horseshoe+adapt] the export from the checkpoint is not "
          "the fit's own export")


def scenario_phase(torch, dt, cuda_lib, k1, k5, card: str, Y, L, noise,
                   work: str) -> dict:
    """(12) The scenario slice: (a) graph == eager on DL, horseshoe +
    rank_adapt, MGP + rank_adapt and horseshoe + rank_adapt under the
    fused Lambda kernel at the north-star width on true-rank-4 data; (b)
    the DL fit at the north-star width (BASELINE config 4's prior on
    config 3's data) with its prior update's device time; (c) config 5;
    (d) the horseshoe + rank_adapt kill and resume.  Returns the launches
    of each path's fit and config 5's reference for step 14."""
    c = FIT
    t0 = time.perf_counter()
    Y4, _, _ = synthetic(c["n"], c["p"], 4)
    for label, model, _ in SCEN_PATHS:
        cfg = path_config(dt, model, {})
        if cfg.model.rank_adapt:
            # columns drop and return within the window, so trips after
            # the first (graph replays) change the mask
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(
                cfg.model, adapt=dt.AdaptConfig(**SCEN_ADAPT)))
        graph_equality_phase(torch, cuda_lib, cfg, Y4, card, label, 8,
                             trips=12, burn_trips=8)
    say(f"scenario graph phase done in {time.perf_counter() - t0:.1f} s")
    label, model, kernels = SCEN_PATHS[0]
    got, cfg, err, res = fit_phase(torch, dt, cuda_lib, card, label, model,
                                   {}, kernels, Y, L, noise)
    blk, blk_s = blockwise_errors(torch, res, Y, L, noise)
    dense, dense_s = rel_errors(torch, res.Sigma, Y, L, noise)
    say(f"fit [dl]: rel Frobenius error block by block {blk:.6f} (sample "
        f"{blk_s:.6f}) against dense {dense:.6f} ({dense_s:.6f}); ranks "
        f"{res.stats.rank_min:g} / {res.stats.rank_mean:g} / "
        f"{res.stats.rank_max:g}")
    check(abs(blk - dense) <= 1e-4 * dense
          and abs(blk_s - dense_s) <= 1e-4 * dense_s,
          "the blockwise quality check disagrees with the dense one")
    del res
    busy = sweep_profile(torch, cfg, Y, card, "dl")
    prior_update_profile(torch, cfg, Y, card, "dl", busy)
    for label, model, _ in SCEN_PATHS[1:]:
        cfg = path_config(dt, model, {})
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, adapt=dt.AdaptConfig(**SCEN_ADAPT)))
        busy = sweep_profile(torch, cfg, Y4, card, label)
        if label != "horseshoe+adapt fused":
            prior_update_profile(torch, cfg, Y4, card, label, busy)
    launches = {"dl": got}
    say(f"scenario DL phase done in {time.perf_counter() - t0:.1f} s")
    launches["config 5 horseshoe+adapt"], c5 = config5_phase(
        torch, dt, cuda_lib, k1, k5, card)
    say(f"config 5 phase done in {time.perf_counter() - t0:.1f} s")
    scenario_kill_phase(torch, dt, cuda_lib, card, Y4, work)
    say(f"scenario phase done in {time.perf_counter() - t0:.1f} s")
    return launches, c5


# ---------------------------------------------------------------------------
# (13) the last scenario knobs: missing values, stored draws, the R-hat
# early stop
# ---------------------------------------------------------------------------

MISSING_FRAC = 0.10          # of Y's entries masked as missing (MCAR)


def mcar(Y: np.ndarray, frac: float, seed: int = 13) -> tuple:
    """Y with a ``frac`` of its entries missing completely at random (NaN),
    and the mask (numpy seed ``seed``)."""
    mask = np.random.default_rng(seed).random(Y.shape) < frac
    Ym = Y.copy()
    Ym[mask] = np.nan
    return Ym, mask


def impute_profile(torch, cfg, Ym, card: str, busy_ms: float) -> None:
    """Device time of one imputation at the chain's width (on chain 0's
    state after 24 sweeps, its normals pre-drawn, as the graph runs it)
    and its share of the sweep's device busy; the bytes of every variate
    a sweep draws (the recipe's slots) and their device time outside the
    graph, with the imputation's part."""
    from dcfm_tpu_torch.models.conditionals import impute_missing_y
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import (
        BufferedDraws, RecordingDraws, TorchNoise, draw_into)
    m, Yd, prior = chain_setup(torch, cfg, Ym)
    runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=0,
                         thin=4, unroll=1)
    carry = runner.init_chain(0)
    runner.run_chunk(0, carry, 24)
    st, mask = carry.state, torch.isnan(Yd)
    noise = TorchNoise(5, "cuda")
    recipe: list = []
    impute_missing_y(RecordingDraws(noise.sweep(0, 0), recipe), Yd, st,
                     m.rho, mask)
    slots = [torch.empty(call.shape, device="cuda") for call in recipe]

    def draw():
        draw_into(noise.sweep(0, 1), recipe, slots)

    def impute():
        impute_missing_y(BufferedDraws(recipe, slots), Yd, st, m.rho, mask)

    draw()
    imp, drw = device_ms(impute, 20), device_ms(draw, 20)
    all_bytes = sum(4 * t.numel() for t in runner._slots)

    def draw_all():
        draw_into(noise.sweep(0, 2), runner._recipe,
                  [t[0] for t in runner._slots])

    drw_all = device_ms(draw_all, 20)
    say(f"impute [f32 missing]: {imp * 1e3:.2f} us of device time per "
        f"sweep, {imp / busy_ms:.1%} of the sweep's device busy "
        f"{busy_ms:.3f} ms; the sweep's {len(runner._recipe)} pre-drawn "
        f"calls hold {all_bytes} bytes, drawn outside the graph in "
        f"{drw_all * 1e3:.2f} us of device time, the imputation's normals "
        f"{sum(4 * t.numel() for t in slots)} bytes of them in "
        f"{drw * 1e3:.2f} us; {card}")
    del runner, carry
    torch.cuda.empty_cache()


def missing_phase(torch, dt, cuda_lib, card: str, Y, L, noise,
                  work: str) -> None:
    """(13a) 10% of Y missing at random on the float32 path: graph ==
    eager with the imputation sum; the fit (K1 and K5 once per sweep, the
    quality rule against the truth, the imputation's RMSE at the missing
    entries below the column means'); device busy per sweep and the
    imputation's share; a child killed mid-run and resumed in a fresh
    process, bitwise."""
    c = FIT
    Ym, mask = mcar(Y, MISSING_FRAC)
    label0, model, backend, kernels = FIT_PATHS[0]
    cfg = path_config(dt, model, backend)
    # the model a fit on Ym runs (fit turns the imputation on itself)
    icfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, impute_missing=True))
    graph_equality_phase(torch, cuda_lib, icfg, Ym, card, "f32 missing", 8)
    dt.fit(Ym, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2,
                                                         mcmc=2)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Ym)
    peak = torch.cuda.max_memory_allocated()
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    ph = res.phase_seconds
    say(f"missing [f32]: {int(mask.sum())} of {mask.size} entries missing "
        f"({MISSING_FRAC:.0%} MCAR), n_missing {res.preprocess.n_missing}; "
        f"{sweeps} sweeps in {ph['chain_s']:.3f} s chain time = "
        f"{sweeps / ph['chain_s']:.2f} chain iterations/s (wall "
        f"{wall:.3f} s), peak allocated {peak} bytes "
        f"({peak / 2**30:.3f} GiB); {card}")
    check(res.preprocess.n_missing == int(mask.sum()), "n_missing")
    check_fit(torch, res, launches, "f32 missing", kernels, Y, L, noise)
    say(f"missing [f32]: nonfinite_count {res.stats.nonfinite_count:g}")
    Yi = res.Y_imputed
    check(Yi is not None and Yi.shape == Y.shape
          and bool(np.isfinite(Yi).all())
          and np.array_equal(Yi[~mask], Ym[~mask]),
          "Y_imputed: not finite, or an observed entry changed")
    rmse = float(np.sqrt(np.mean((Yi[mask] - Y[mask]) ** 2)))
    col_mean = np.broadcast_to(np.nanmean(Ym, axis=0), Y.shape)
    base = float(np.sqrt(np.mean((col_mean[mask] - Y[mask]) ** 2)))
    say(f"missing [f32]: imputation RMSE at the missing entries {rmse:.6f} "
        f"against the column means' {base:.6f} ({rmse / base:.3f}x)")
    check(rmse < base, "the imputation is no better than the column means")
    del res
    busy = sweep_profile(torch, icfg, Ym, card, "f32 missing")
    impute_profile(torch, icfg, Ym, card, busy)
    # killed mid-run, resumed in a fresh process
    ref = dt.fit(Ym, ckpt_config(dt, "f32", KILL_RUN))
    want = {"sigma": sigma_digest(ref.Sigma),
            "state": state_digest(ref.state),
            "y_imputed": sigma_digest(ref.Y_imputed)}
    del ref
    path = os.path.join(work, "f32_missing.npz")
    spec = {"path": "f32", "run": KILL_RUN, "missing": MISSING_FRAC,
            "fit": {"checkpoint_path": path, "checkpoint_every_chunks": 1}}
    killed = run_child(spec, work, "missing_killed", kill_at=KILL_AT,
                       path=path)["killed_at"]
    out = run_child(dict(spec, fit=dict(spec["fit"], resume=True)), work,
                    "missing_resumed")
    same = {k: out[k] == v for k, v in want.items()}
    say(f"kill [f32 missing]: killed with the file at iteration {killed}, "
        f"resumed in a fresh process: executed {out['executed']}; Sigma, "
        f"state and Y_imputed equal to the uninterrupted fit's: "
        f"{json.dumps(same)}; {card}")
    check(all(same.values()) and out["executed"] < sum(KILL_RUN.values()),
          "[f32 missing] the resumed fit is not the uninterrupted one")


def draws_phase(torch, dt, cuda_lib, card: str, Y, L, noise,
                f32_digest: str) -> None:
    """(13b) store_draws on the float32 path: graph == eager with the
    ring; the fit's Sigma bitwise the fit without it; the ring's bytes
    against the reckoning; for 64 sampled entries the mean of the stored
    draws' entries against the accumulated mean, and the 95% credible
    interval around it; the device time a saved draw adds."""
    from dcfm_tpu_torch.models.conditionals import cross_moments
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import TorchNoise
    from dcfm_tpu_torch.utils.estimate import draw_covariance_entries
    from dcfm_tpu_torch.utils.preprocess import caller_to_shard_index
    c = FIT
    label0, model, backend, kernels = FIT_PATHS[0]
    base = path_config(dt, model, backend)
    graph_equality_phase(torch, cuda_lib, base, Y, card, "f32 store_draws",
                         8, num_stored_draws=(10 * 8 - 2 * 8) // 3)
    if f32_digest is None:          # --knobs-only: the fit without the ring
        f32_digest = sigma_digest(dt.fit(Y, base).Sigma)
    cfg = dataclasses.replace(base, run=dataclasses.replace(
        base.run, store_draws=True))
    res, launches, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
    check_fit(torch, res, launches, "f32 store_draws", kernels, Y, L, noise)
    digest = sigma_digest(res.Sigma)
    say(f"draws [f32]: Sigma sha256 {digest} "
        f"{'=' if digest == f32_digest else '!='} the f32 fit's without "
        f"store_draws ({f32_digest}); wall {wall:.3f} s")
    check(digest == f32_digest, "storing draws changed Sigma")
    C, S = c["chains"], res.config.run.num_saved
    g, K, P, n = c["g"], c["K"], res.preprocess.shard_size, c["n"]
    reckoned = {"Lambda": S * g * P * K * 4, "ps": S * g * P * 4,
                "X": S * n * K * 4, "H": S * g * g * K * K * 4}
    got = {k: v.nbytes // C for k, v in res.draws.items()}
    say(f"draws [f32]: the ring per chain at S = {S}: {json.dumps(got)} = "
        f"{sum(got.values())} bytes (reckoned {json.dumps(reckoned)} = "
        f"{sum(reckoned.values())})")
    check(got == reckoned, "the ring's bytes are not the reckoned ones")
    rng = np.random.default_rng(17)
    rows = rng.integers(0, c["p"], 64)
    cols = np.concatenate([rows[:8], rng.integers(0, c["p"], 56)])
    pre = res.preprocess
    sr, sc = (caller_to_shard_index(pre, x) for x in (rows, cols))
    vals = draw_covariance_entries(res.draws, sr, sc, rho=c["rho"])
    s = np.asarray(pre.col_scale).reshape(-1)
    vals = vals * (s[sr] * s[sc])[None, :]
    mean = res.Sigma[rows, cols]
    scale = float(np.abs(mean).max())
    err = float(np.abs(vals.mean(axis=0) - mean).max()) / scale
    say(f"draws [f32]: 64 entries (8 diagonal): the mean over {C * S} "
        f"stored draws against the accumulated mean, max |diff| / max "
        f"|entry| {err:.3e}")
    check(err <= 1e-4, "the stored draws do not reproduce the accumulator")
    lo, hi = res.covariance_credible_interval(rows, cols, alpha=0.05)
    inside = (lo <= mean + 1e-6 * scale) & (mean <= hi + 1e-6 * scale)
    say(f"draws [f32]: 95% credible intervals bracket the posterior mean "
        f"for {int(inside.sum())} of 64 entries; median width "
        f"{float(np.median(hi - lo)):.4e}")
    check(bool(inside.all()), "a credible interval misses the mean")
    del res
    # what a saved draw adds: the ring's writes (H is the combine's own
    # cross-moments, formed either way)
    m, Yd, prior = chain_setup(torch, cfg, Y)
    runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=0,
                         thin=1, unroll=1, num_stored_draws=S)
    carry = runner.init_chain(0)
    runner.run_chunk(0, carry, 4)
    st = carry.state
    eta = (math.sqrt(m.rho) * st.X[None]
           + math.sqrt(1.0 - m.rho) * st.Z)
    H = cross_moments(eta)
    its = torch.full((1,), 3.0, device="cuda")
    store = device_ms(lambda: runner._store(carry.draws, st, H, its[0]), 50)
    h_ms = device_ms(lambda: cross_moments(eta), 50)
    say(f"draws [f32]: a saved draw's ring writes take {store * 1e3:.2f} us "
        f"of device time ({sum(reckoned.values()) // S} bytes); its H, "
        f"{h_ms * 1e3:.2f} us, is the combine's own; {card}")
    del runner, carry
    torch.cuda.empty_cache()


def early_stop_phase(torch, dt, cuda_lib, card: str, Y) -> None:
    """(13c) early_stop="rhat" on the float32 path, 2 chains of KILL_RUN
    in chunks of CKPT_CHUNK: the thresholds picked from the uninterrupted
    run's own trajectory so that the stop fires at the last boundary
    before the end that no earlier boundary dominates (none with an R-hat
    as low and an ESS as high: the stop there passes both thresholds and
    every earlier boundary fails one); the stopped fit bitwise an
    early_stop="off" fit of the short schedule; its checkpoint resumed
    with early_stop="off" to the full schedule bitwise the uninterrupted
    run."""
    import tempfile

    from dcfm_tpu_torch.runtime.pipeline import early_stop_metrics
    c = FIT
    burnin, total = KILL_RUN["burnin"], sum(KILL_RUN.values())
    cfg = ckpt_config(dt, "f32", KILL_RUN)
    full = dt.fit(Y, cfg)
    full_digest = sigma_digest(full.Sigma)
    say("early stop: the uninterrupted run's diagnostics per trace summary "
        "(post-burn-in): " + json.dumps(full.diagnostics))
    chunks = [(s, full.traces[:, s:s + CKPT_CHUNK])
              for s in range(0, total, CKPT_CHUNK)]
    traj = [(s + CKPT_CHUNK,) + early_stop_metrics(
        chunks[:i + 1], 0, burnin) for i, (s, _) in enumerate(chunks)]
    del full
    rows = [(it, rh, es) for it, rh, es in traj
            if np.isfinite(rh) and np.isfinite(es)]
    stop = None
    for i, (it, rh, es) in enumerate(rows):
        # the stop's own values as the thresholds: it passes them, and an
        # earlier boundary passes them only if it dominates it
        r_th, e_th = max(rh, 1.0) + 1e-6, es
        if it < total and not any(r < r_th and e >= e_th
                                  for _, r, e in rows[:i]):
            stop, rhat_threshold, ess_target = it, r_th, e_th
    check(stop is not None, f"no boundary to stop at in {traj}")
    say(f"early stop: trajectory of the uninterrupted run (iteration, max "
        f"split-R-hat, min pooled ESS): "
        + ", ".join(f"({it}, {rh:.4f}, {es:.1f})" for it, rh, es in traj)
        + f"; thresholds rhat < {rhat_threshold:.6f}, ess >= "
        f"{ess_target:.4f} (stop expected at {stop})")
    with tempfile.TemporaryDirectory(prefix="dcfm_es_") as d:
        path = os.path.join(d, "es.npz")
        es_cfg = dataclasses.replace(cfg, checkpoint_path=path,
                                     run=dataclasses.replace(
                                         cfg.run, early_stop="rhat",
                                         rhat_threshold=rhat_threshold,
                                         ess_target=ess_target))
        res, launches, wall = counted_fit(torch, dt, cuda_lib, es_cfg, Y)
        got = res.stopped_at_iter
        sweeps = c["chains"] * (got or total)
        say(f"early stop: stopped_at_iter {got}, rhat_trajectory "
            f"{np.round(res.rhat_trajectory, 4).tolist()}; {sweeps} sweeps, "
            f"chain_s {res.phase_seconds['chain_s']:.3f}, wall {wall:.3f} "
            f"s; launches {json.dumps(launches)}; {card}")
        check(got == stop, f"the stop fired at {got}, expected {stop}")
        check(launches["chol_sample"] == sweeps
              and launches["sse_ps"] == sweeps,
              "the stopped fit's launches are not one per executed sweep")
        stopped = sigma_digest(res.Sigma)
        del res
        short = dt.fit(Y, dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, mcmc=stop - burnin)))
        say(f"early stop: Sigma {stopped[:16]} "
            f"{'=' if sigma_digest(short.Sigma) == stopped else '!='} the "
            f"early_stop='off' fit of {stop} iterations")
        check(sigma_digest(short.Sigma) == stopped,
              "the stopped fit is not the short schedule's")
        del short
        resumed = dt.fit(Y, dataclasses.replace(cfg, checkpoint_path=path,
                                                resume=True))
        say(f"early stop: the stopped file (iteration "
            f"{total - resumed.traces.shape[1]}) resumed with "
            f"early_stop='off' to {total}: Sigma "
            f"{'=' if sigma_digest(resumed.Sigma) == full_digest else '!='}"
            f" the uninterrupted run's")
        check(sigma_digest(resumed.Sigma) == full_digest
              and resumed.traces.shape[1] == total - stop,
              "the resumed stopped file is not the uninterrupted run")


def knobs_phase(torch, dt, cuda_lib, card: str, Y, L, noise, digests: dict,
                work: str) -> None:
    """(13) missing values, stored draws, the early stop; then (d) the
    digests of every path with the new knobs off."""
    t0 = time.perf_counter()
    missing_phase(torch, dt, cuda_lib, card, Y, L, noise, work)
    say(f"missing phase done in {time.perf_counter() - t0:.1f} s")
    draws_phase(torch, dt, cuda_lib, card, Y, L, noise, digests["f32"])
    say(f"draws phase done in {time.perf_counter() - t0:.1f} s")
    early_stop_phase(torch, dt, cuda_lib, card, Y)
    say(f"early stop phase done in {time.perf_counter() - t0:.1f} s")
    say("new knobs off: Sigma sha256 " + json.dumps(digests)
        + " (scripts/torch_sigma_hashes.py holds them against another "
        "tree)")


# ---------------------------------------------------------------------------
# (14) scale on one card: the streaming ingest and the chunked combine
# ---------------------------------------------------------------------------

# the chunked combine's ranges at config 5 (16 divides g = 256)
CONFIG5_CHUNKS = 16


def vm_kb(status: str, field: str) -> int:
    """A kB field (VmRSS, VmHWM) of a /proc/<pid>/status text."""
    for line in status.splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1])
    fail(f"no {field} in a /proc status")


def rss_probe(spec: dict) -> None:
    """``--fit-child '{"rss_probe": PATH, "g": G}'``: the preprocess and the
    upload to the card of a config-5 fit of the .npy at PATH (an
    np.memmap, or with "dense" the array read whole before the baseline)
    in this fresh process.  It says "ready" once CUDA is up and the input
    open, and waits for a line on stdin, so that the parent can sample
    its resident set from outside; then prints the two phases' seconds,
    whether the ingest was lazy, and its own ru_maxrss growth (which
    CUDA's start-up may already have set above anything the ingest
    reaches)."""
    import resource

    import torch

    from dcfm_tpu_torch.runtime.fetch import upload_data
    from dcfm_tpu_torch.utils.preprocess import preprocess
    check(torch.cuda.is_available(), "the probe child sees no CUDA device")
    torch.ones(1 << 18).to("cuda")           # 1 MB: the context, the copy
    torch.cuda.synchronize()
    Y = np.load(spec["rss_probe"],
                mmap_mode=None if spec.get("dense") else "r")
    say("ready")
    sys.stdin.readline()
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    t = time.perf_counter()
    pre = preprocess(Y, spec["g"], seed=0)
    t_pre = time.perf_counter() - t
    t = time.perf_counter()
    Yd = upload_data(pre.data, "float32", "cuda")
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t
    after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    say(json.dumps({"ru_maxrss_growth_bytes": (after - before) * 1024,
                    "preprocess_s": t_pre, "upload_s": t_up,
                    "lazy": pre.is_lazy, "shape": list(Yd.shape),
                    "shards_per_chunk": (pre.data.shards_per_chunk
                                         if pre.is_lazy else None)}))


def sampled_rss_probe(spec: dict, workdir: str, name: str,
                      timeout: float = 300.0) -> dict:
    """An ``rss_probe`` child whose resident set this process samples from
    /proc/<pid>/status while it ingests (every ~0.2 ms: a lower bound of
    its peak); returns the child's JSON line with "sampled_growth_bytes"
    (the largest VmRSS seen minus the VmRSS at its "ready") and "samples".
    """
    log_path = os.path.join(workdir, name + ".out")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--fit-child",
         json.dumps(spec)], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=open(log_path, "w"), text=True)
    try:
        line = proc.stdout.readline().strip()
        check(line == "ready", f"[{name}] the probe child said {line!r}: "
              f"{open(log_path).read()[-2000:]}")
        status = f"/proc/{proc.pid}/status"
        base = peak = vm_kb(open(status).read(), "VmRSS")
        proc.stdin.write("go\n")
        proc.stdin.flush()
        samples = 0
        deadline = time.perf_counter() + timeout
        while proc.poll() is None and time.perf_counter() < deadline:
            try:
                text = open(status).read()
            except OSError:
                break
            if "VmRSS" not in text:
                break                        # exiting: its mm is gone
            peak = max(peak, vm_kb(text, "VmRSS"))
            samples += 1
            time.sleep(0.0002)
        out, _ = proc.communicate(timeout=max(1.0, deadline
                                              - time.perf_counter()))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(proc.returncode == 0, f"[{name}] the probe child failed "
          f"({proc.returncode}): {open(log_path).read()[-2000:]}")
    res = json.loads(out.strip().splitlines()[-1])
    res.update(sampled_growth_bytes=(peak - base) * 1024, samples=samples)
    return res


def check_path_launches(launches: dict, sweeps: int, label: str) -> None:
    """K1 and K5 once per sweep, every other kernel not at all."""
    say(f"{label} kernel launches: {json.dumps(launches)} (expected "
        f"{sweeps} for chol_sample and sse_ps, 0 for the others)")
    for name, count in launches.items():
        want = sweeps if name in ("chol_sample", "sse_ps") else 0
        check(count == want, f"[{label}] {name} launched {count} times in "
              f"{sweeps} sweeps, expected {want}")


def memmap_phase(torch, dt, cuda_lib, card: str, work: str, c5) -> dict:
    """(14a) config 5 fitted from an np.memmap of its float32 .npy under
    step 12(c)'s config with materialize_sigma="auto" (packed: the input
    is lazy): the int8 panels and scales bitwise the dense fit's (step
    12(c)'s, or one made here when ``c5`` is None), no Sigma and
    covariance() refused, K1 and K5 once per sweep, the quality rule block
    by block, chain iterations/s, preprocess_s and upload_s against the
    dense fit's, and the host peak of the preprocess and upload in fresh
    processes (the memmap's and, for reference, the dense array's)."""
    from dcfm_tpu_torch.utils.preprocess import LazyMaterializationError
    c = CONFIG5
    g, P, n = c["g"], c["p"] // c["g"], c["n"]
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    Y5, L5, noise = synthetic(n, c["p"], c["k_true"])
    path = os.path.join(work, "Y5.npy")
    np.save(path, Y5)
    Ymm = np.load(path, mmap_mode="r")
    say(f"(14a) config 5 data as a float32 .npy: {os.path.getsize(path)} "
        f"bytes on disk ({Y5.nbytes} of data), opened as an np.memmap")
    cfg = config5_config(dt)
    if c5 is None:                  # --ingest-only: the dense twin here
        dt.fit(Y5, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2,
                                                              mcmc=2)))
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res, launches, _ = counted_fit(torch, dt, cuda_lib, cfg, Y5)
        c5 = {"q8": q8_digest(res), "phase": res.phase_seconds,
              "peak": torch.cuda.max_memory_allocated()}
        check_path_launches(launches, sweeps, "(14a) dense twin")
        del res
        torch.cuda.empty_cache()
    dense_bytes = g * n * P * 4
    probes = [sampled_rss_probe({"rss_probe": path, "g": g} | kind, work,
                                f"rss_{i}")
              for i, kind in enumerate(({}, {"dense": True}))]
    mm_p, dense_p = probes
    check(mm_p["lazy"] and not dense_p["lazy"], "[14a] the probes' kinds")
    spc = mm_p["shards_per_chunk"]
    say(f"(14a) host peak of preprocess + upload in a fresh process, "
        f"VmRSS sampled from outside ({mm_p['samples']} / "
        f"{dense_p['samples']} samples): memmap "
        f"{mm_p['sampled_growth_bytes']} bytes, dense "
        f"{dense_p['sampled_growth_bytes']} bytes of growth, against half "
        f"the dense (g, n, P) tensor, {dense_bytes // 2} bytes (the "
        f"children's own ru_maxrss growth: {mm_p['ru_maxrss_growth_bytes']}"
        f" / {dense_p['ru_maxrss_growth_bytes']}); reckoned for the memmap:"
        f" a 4,194,304-byte row buffer of positioned reads plus a block of "
        f"{spc} shards twice ({2 * spc * n * P * 4} bytes: the gathered "
        f"columns and the shard-major block); preprocess / upload s: "
        f"memmap {mm_p['preprocess_s']:.3f} / {mm_p['upload_s']:.3f}, "
        f"dense {dense_p['preprocess_s']:.3f} / {dense_p['upload_s']:.3f}; "
        f"{card}")
    check(mm_p["sampled_growth_bytes"] < dense_bytes // 2,
          f"[14a] the memmap ingest's host peak "
          f"{mm_p['sampled_growth_bytes']} bytes is not below half the "
          f"dense tensor ({dense_bytes // 2})")
    lazy_cfg = dataclasses.replace(cfg, materialize_sigma="auto")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_fit(torch, dt, cuda_lib, lazy_cfg, Ymm)
    peak = torch.cuda.max_memory_allocated()
    ph = res.phase_seconds
    check_path_launches(launches, sweeps, "(14a) memmap")
    check(res.preprocess.is_lazy and res.Sigma is None
          and res.graphs["replays"] > 0,
          "[14a] the memmap fit was not lazy, formed a Sigma or ran no graph")
    check(res.stats.nonfinite_count == 0 and res.stats.acc_nonfinite == 0,
          f"[14a] chain health: {res.stats}")
    try:
        res.covariance()
        refused = False
    except LazyMaterializationError:
        refused = True
    check(refused, "[14a] covariance() of the lazy fit did not refuse")
    digest = q8_digest(res)
    say(f"(14a) memmap fit int8 panels and scales sha256 {digest}; dense "
        f"fit {c5['q8']}: {'bitwise equal' if digest == c5['q8'] else 'DIFFER'}")
    check(digest == c5["q8"], "[14a] the memmap fit's panels are not the "
          "dense fit's")
    d = c5["phase"]
    say(f"(14a) memmap fit: {sweeps} sweeps in {ph['chain_s']:.3f} s chain "
        f"time = {sweeps / ph['chain_s']:.2f} chain iterations/s (wall "
        f"{wall:.3f} s); preprocess_s {ph['preprocess_s']:.3f} (dense "
        f"{d['preprocess_s']:.3f}), upload_s {ph['upload_s']:.4f} (dense "
        f"{d['upload_s']:.4f}); peak allocated {peak} bytes (dense fit "
        f"{c5['peak']}); Sigma None, covariance() refused; {card}")
    say("(14a) memmap phase_seconds: " + json.dumps(ph))
    t = time.perf_counter()
    err, err_s = blockwise_errors(torch, res, Y5, L5, noise)
    say(f"(14a) memmap fit rel Frobenius error vs truth (block by block, "
        f"{time.perf_counter() - t:.1f} s): {err:.6f} (sample covariance: "
        f"{err_s:.6f}); ranks {res.stats.rank_min:g} / "
        f"{res.stats.rank_mean:.4f} / {res.stats.rank_max:g}")
    check(err < 0.25 and err <= 2 * err_s, f"[14a] rel Frobenius error "
          f"{err:.4f} outside the quality rule (sample {err_s:.4f})")
    out = {"Y5": Y5, "Ymm": Ymm, "peak": peak, "launches": launches,
           "q8": np.asarray(res._q8_panels), "scales": np.asarray(
               res._q8_scales, np.float32)}
    del res
    torch.cuda.empty_cache()
    return out


def max_panel_diff(torch, q_a, s_a, q_b, s_b, batch: int = 2048) -> tuple:
    """(max |a - b| over the dequantized panels, int8 entries that differ,
    panels whose scales differ), on the card in batches of panels."""
    dev = torch.device("cuda")
    worst, entries = 0.0, 0
    for i in range(0, q_a.shape[0], batch):
        sa = torch.as_tensor(s_a[i:i + batch], device=dev) / 127.0
        sb = torch.as_tensor(s_b[i:i + batch], device=dev) / 127.0
        a = torch.as_tensor(np.ascontiguousarray(q_a[i:i + batch]),
                            device=dev)
        b = torch.as_tensor(np.ascontiguousarray(q_b[i:i + batch]),
                            device=dev)
        entries += int((a != b).sum())
        diff = (a.float() * sa[:, None, None]
                - b.float() * sb[:, None, None]).abs().max()
        worst = max(worst, float(diff))
    return worst, entries, int((s_a != s_b).sum())


def saved_trip_peak(torch, cfg, Y) -> int:
    """Peak allocated above its start of one saved sweep of one eager chain
    (after a burn-in sweep): the transient a saved draw's combine adds on
    top of the carry."""
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import TorchNoise
    m, Yd, prior = chain_setup(torch, cfg, Y)
    runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=1,
                         thin=1, unroll=1, graphs=False)
    runner.init_chain(0)
    runner._trip(0, 0, (False,))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    runner._trip(0, 1, (True,))
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    del runner, Yd
    torch.cuda.empty_cache()
    return peak


def chunked_phase(torch, dt, cuda_lib, card: str, a: dict) -> dict:
    """(14b) (14a) with combine_chunks=CONFIG5_CHUNKS: graph == eager on
    one chain for 10 trips (the accumulators included) and that chain's
    float32 accumulator against the unchunked chain's, the fit from the
    memmap with K1 and K5 once per sweep, the max |chunked - unchunked|
    of its int8 panels, peak allocated against (14a)'s, one saved sweep's
    transient chunked and unchunked, and device busy per sweep against
    the unchunked chain's with the add and GEMM kernels' times (the
    accumulator add and the combine)."""
    c = CONFIG5
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    cfg = config5_config(dt, combine_chunks=CONFIG5_CHUNKS)
    label = f"config 5 combine_chunks={CONFIG5_CHUNKS}"
    acc = graph_equality_phase(torch, cuda_lib, cfg, a["Y5"], card, label,
                               8, trips=10, burn_trips=4)
    flat = graph_equality_phase(torch, cuda_lib, config5_config(dt),
                                a["Y5"], card, "config 5 unchunked", 8,
                                trips=10, burn_trips=4)
    top = float(flat.abs().max())
    worst = float((acc - flat).abs().max())
    say(f"(14b) the same chain's float32 accumulator after 10 trips, "
        f"chunked against unchunked: max |difference| {worst:.6g} of a "
        f"largest entry {top:.6g} ({worst / top:.3g} relative); "
        f"bitwise {bool(torch.equal(acc, flat))}")
    # float32: the chunked GEMMs may take other cuBLAS algorithms, whose
    # K-term sums round in another order (the tolerance of the CPU tests)
    check(worst <= 1e-5 * top, f"[14b] chunked accumulator off by {worst} "
          f"(> 1e-5 of {top})")
    del acc, flat
    torch.cuda.empty_cache()
    from dcfm_tpu_torch.models.state import num_padded_pairs
    g, P, K = c["g"], c["p"] // c["g"], c["K"]
    Qp = num_padded_pairs(g)
    trips = {x: saved_trip_peak(torch, config5_config(dt, combine_chunks=x),
                                a["Y5"]) for x in (1, CONFIG5_CHUNKS)}
    say(f"(14b) one saved sweep's transient above the carry (peak "
        f"allocated above its start, eager): unchunked {trips[1]} bytes, "
        f"combine_chunks={CONFIG5_CHUNKS} {trips[CONFIG5_CHUNKS]} bytes; "
        f"reckoned: the panel temporary {Qp * P * P * 4} / "
        f"{(Qp // CONFIG5_CHUNKS) * P * P * 4} bytes plus three (Q, P, K) "
        f"gathers of {Qp * P * K * 4} / {(Qp // CONFIG5_CHUNKS) * P * K * 4} "
        f"bytes; {card}")
    check(trips[CONFIG5_CHUNKS] < trips[1], "[14b] the chunked combine did "
          "not shrink a saved sweep's transient")
    lazy_cfg = dataclasses.replace(cfg, materialize_sigma="auto")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, launches, wall = counted_fit(torch, dt, cuda_lib, lazy_cfg,
                                      a["Ymm"])
    peak = torch.cuda.max_memory_allocated()
    ph = res.phase_seconds
    check_path_launches(launches, sweeps, "(14b) chunked")
    check(res.Sigma is None and res.graphs["replays"] > 0
          and res.stats.nonfinite_count == 0
          and res.stats.acc_nonfinite == 0,
          f"[14b] the chunked fit: Sigma formed, no graph, or {res.stats}")
    worst, entries, scales = max_panel_diff(
        torch, np.asarray(res._q8_panels),
        np.asarray(res._q8_scales, np.float32), a["q8"], a["scales"])
    top = float(np.abs(a["scales"]).max())
    say(f"(14b) the fits' int8 panels: max |chunked - unchunked| of the "
        f"dequantized panels {worst:.6g} (largest panel scale {top:.6g}; "
        f"one int8 step of it {top / 127:.6g}), {entries} int8 entries "
        f"and {scales} panel scales differ")
    # the f32 tolerance carried through the quant8 link: a panel entry may
    # round to the neighbouring int8 step when its float32 sum differs in
    # the last places
    check(worst <= 1.01 * top / 127, f"[14b] the chunked panels differ by "
          f"{worst} > one int8 step of the largest scale")
    say(f"(14b) chunked fit: {sweeps} sweeps in {ph['chain_s']:.3f} s chain "
        f"time = {sweeps / ph['chain_s']:.2f} chain iterations/s (wall "
        f"{wall:.3f} s); peak allocated {peak} bytes ({peak / 2**30:.3f} "
        f"GiB) against the unchunked {a['peak']} bytes "
        f"({a['peak'] / 2**30:.3f} GiB); {card}")
    say("(14b) chunked phase_seconds: " + json.dumps(ph))
    del res
    torch.cuda.empty_cache()
    busy = {}
    for name, cfgx in (("unchunked", config5_config(dt)), ("chunked", cfg)):
        rows: list = []
        b = sweep_profile(torch, cfgx, a["Y5"], card, f"config 5 {name}",
                          rows)
        adds = sum(us for k, us in rows if "Functor_add" in k)
        gemms = sum(us for k, us in rows if "gemm" in k.lower())
        busy[name] = b
        say(f"(14b) config 5 {name}: device busy {b:.4f} ms per sweep; the "
            f"add kernels (the accumulator's among them) {adds:.2f} us, the "
            f"GEMM kernels (the combine's among them) {gemms:.2f} us per "
            f"sweep; {card}")
    say(f"(14b) device busy per sweep chunked / unchunked: "
        f"{busy['chunked'] / busy['unchunked']:.4f}")
    return launches


def csr_phase(torch, dt, cuda_lib, card: str, Y) -> dict:
    """(14c) step 4's Y at the north-star width made sparse (|y| below its
    90th percentile zeroed), 0.5% stored NaN and one all-zero column,
    fitted as a SparseMatrix CSR on the f32 path under
    materialize_sigma="always" against the dense fit of the densified
    array: upper panels and Sigma bitwise, Y_imputed None on the lazy fit,
    n_missing equal, K1 and K5 once per sweep in both."""
    from dcfm_tpu_torch.utils.preprocess import SparseMatrix
    c = FIT
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    Ys = np.array(Y, np.float32, copy=True)
    Ys[np.abs(Ys) < np.percentile(np.abs(Ys), 90)] = 0.0
    Ys[np.random.default_rng(14).random(Ys.shape) < 0.005] = np.nan
    Ys[:, 17] = 0.0
    keep = (Ys != 0) | np.isnan(Ys)
    rows, cols = np.nonzero(keep)
    indptr = np.zeros(Ys.shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=Ys.shape[0]), out=indptr[1:])
    csr = SparseMatrix(indptr, cols, Ys[rows, cols], Ys.shape)
    say(f"(14c) CSR at the north-star width: {Ys.shape}, {rows.size} "
        f"stored entries (density {keep.mean():.4f}), "
        f"{int(np.isnan(Ys).sum())} stored NaN, column 17 all zero")
    cfg = path_config(dt, *FIT_PATHS[0][1:3])
    got, got_launches = {}, {}
    for label, inp, kw in (("dense", Ys, {}),
                           ("csr", csr, {"materialize_sigma": "always"})):
        torch.cuda.synchronize()
        res, launches, wall = counted_fit(
            torch, dt, cuda_lib, dataclasses.replace(cfg, **kw), inp)
        check_path_launches(launches, sweeps, f"(14c) {label}")
        check(res.stats.nonfinite_count == 0
              and res.stats.acc_nonfinite == 0,
              f"[14c] {label} chain health: {res.stats}")
        ph = res.phase_seconds
        say(f"(14c) {label} fit: {sweeps / ph['chain_s']:.2f} chain "
            f"iterations/s, preprocess_s {ph['preprocess_s']:.4f}, "
            f"upload_s {ph['upload_s']:.4f}, wall {wall:.3f} s; {card}")
        got[label], got_launches[label] = res, launches
    d, s = got["dense"], got["csr"]
    check(s.preprocess.is_lazy and not d.preprocess.is_lazy
          and 17 in s.preprocess.zero_cols,
          "[14c] the CSR ingest was not lazy or kept the zero column")
    check(s.preprocess.n_missing == d.preprocess.n_missing > 0,
          f"[14c] n_missing {s.preprocess.n_missing} != "
          f"{d.preprocess.n_missing}")
    check(s.Y_imputed is None and d.Y_imputed is not None,
          "[14c] Y_imputed: the lazy fit must have none, the dense one one")
    same_panels = bool(np.array_equal(s.upper_panels, d.upper_panels))
    same_sigma = sigma_digest(s.Sigma) == sigma_digest(d.Sigma)
    say(f"(14c) CSR against dense: upper panels bitwise {same_panels}, "
        f"Sigma sha256 {sigma_digest(s.Sigma)} / {sigma_digest(d.Sigma)} "
        f"(bitwise {same_sigma}); n_missing {s.preprocess.n_missing}; "
        f"Y_imputed None on the CSR fit")
    check(same_panels and same_sigma,
          "[14c] the CSR fit is not the dense fit bit for bit")
    return got_launches


def scale_phase(torch, dt, cuda_lib, card: str, Y, work: str,
                c5=None) -> dict:
    """(14) the streaming ingest and the chunked combine on one card.
    Returns the launches of each of its fits."""
    t0 = time.perf_counter()
    a = memmap_phase(torch, dt, cuda_lib, card, work, c5)
    launches = {"config 5 memmap": a["launches"]}
    say(f"(14a) done in {time.perf_counter() - t0:.1f} s")
    launches["config 5 memmap combine_chunks=16"] = chunked_phase(
        torch, dt, cuda_lib, card, a)
    del a
    torch.cuda.empty_cache()
    say(f"(14b) done in {time.perf_counter() - t0:.1f} s")
    csr = csr_phase(torch, dt, cuda_lib, card, Y)
    launches["north-star CSR"] = csr["csr"]
    say(f"(14c) done in {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# step 15: the outer layers - the flight recorder, the profiler trace, warm
# starts and the backend switch
# ---------------------------------------------------------------------------

OUTER_WARM_RUN = {"burnin": 20, "mcmc": 200}
# the killed warm refit: long enough that write-behind saves land well
# before its end (a full save outlasts several chunks at this width)
WARM_KILL_RUN = {"burnin": 20, "mcmc": 800}
# K1 (no division-order flag, with noise) and K5 among a trace's kernel
# names, demangled or not
K1_NAME = re.compile(r"chol_group_kernel(<\d+, \d+, false, true"
                     r"|ILi\d+ELi\d+ELb0ELb1)")
K5_NAME = re.compile(r"sse_ps_(fixed|any)")


def outer_config(dt, *, run=None, backend=None, model=None, **fit_kw):
    """The north-star float32 path in chunks of CKPT_CHUNK with the
    streamed quant8 fetch, columns unpermuted; ``run``, ``backend`` and
    ``model`` change RunConfig, BackendConfig and ModelConfig fields,
    ``fit_kw`` FitConfig fields.

    ``permute=False``: a warm start grafts shard by shard, and only an
    unpermuted layout keeps a donor shard's columns in that shard when
    columns are added (the permutation of p columns is not a prefix of
    the permutation of more)."""
    cfg = ckpt_config(dt, "f32", run, permute=False)
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, **(model or {})),
        backend=dataclasses.replace(cfg.backend, fetch_dtype="quant8",
                                    **(backend or {})), **fit_kw)


class FsyncLog:
    """Times every durable flush of the flight recorder (the chunk
    boundaries' fsyncs): the script's instrumentation around
    obs/recorder.FlightRecorder.flush, removed on exit."""

    def __enter__(self):
        from dcfm_tpu_torch.obs import recorder
        self._cls, self._flush = recorder.FlightRecorder, \
            recorder.FlightRecorder.flush
        self.seconds, self.count = 0.0, 0
        log, flush = self, self._flush

        def timed(rec, fsync=False):
            t = time.perf_counter()
            flush(rec, fsync=fsync)
            if fsync:
                log.seconds += time.perf_counter() - t
                log.count += 1

        self._cls.flush = timed
        return self

    def __exit__(self, *exc):
        self._cls.flush = self._flush


class InitialStates:
    """Each chain's state leaves as its first chunk starts, read off its
    carry before the chain's first trip: the script's instrumentation
    around ChainRunner.run_chunk, removed on exit.  ``leaves(i)``: leaf i
    of every chain, stacked (the chain-axis convention)."""

    def __enter__(self):
        from dcfm_tpu_torch.models import sampler
        self._sampler, self._run = sampler, sampler.ChainRunner.run_chunk
        self.states = {}
        run, states = self._run, self.states

        def capture(runner, c, carry, n):
            if carry.iteration == 0 and c not in states:
                states[c] = [t.detach().cpu().numpy().copy()
                             for t in sampler.state_leaves(carry.state)]
            return run(runner, c, carry, n)

        sampler.ChainRunner.run_chunk = capture
        return self

    def __exit__(self, *exc):
        self._sampler.ChainRunner.run_chunk = self._run

    def leaves(self, i: int) -> np.ndarray:
        return np.stack([self.states[c][i] for c in sorted(self.states)])

    def digest(self) -> str:
        h = hashlib.sha256()
        for c in sorted(self.states):
            for a in self.states[c]:
                h.update(a.tobytes())
        return h.hexdigest()


def donor_leaf(path: str, i: int) -> np.ndarray:
    """Leaf i of a checkpoint, the file CRC-checked first."""
    from dcfm_tpu_torch.utils.checkpoint import verify_checkpoint
    verify_checkpoint(path)
    with np.load(path) as z:
        return z[f"leaf_{i}"]


def outer_events(obs_dir: str, kind: str) -> list:
    from dcfm_tpu_torch.obs import run_events
    return [e for e in run_events(obs_dir) if e["event"] == kind]


def truth_errors(torch, S, Y, L, noise) -> tuple:
    """(rel. Frobenius error of S against L L' + noise^2 I, the sample
    covariance's), on the card, at Y's own n and p."""
    dev = torch.device("cuda")
    n, p = Y.shape
    Sd = torch.as_tensor(S, device=dev)
    Lt = torch.as_tensor(L, device=dev)
    St = Lt @ Lt.T
    St.diagonal().add_(noise ** 2)
    Yc = torch.as_tensor(Y, device=dev)
    Yc = Yc - Yc.mean(dim=0)
    norm = torch.linalg.norm(St)
    err = float(torch.linalg.norm(Sd - St) / norm)
    del Sd
    Ss = Yc.T @ Yc / (n - 1)
    return err, float(torch.linalg.norm(Ss - St) / norm)


def warm_data(Y, L, noise, g2: int, seed: int = 15) -> tuple:
    """(Y with 100 rows appended from the same model; a data set of ``g2``
    shards of Y's shard width P (10,048 / 64 = 157 at the north-star
    width) whose first columns' loadings are L's, with its loadings)."""
    r = np.random.default_rng(seed)
    k = L.shape[1]
    P = -(-L.shape[0] // FIT["g"])
    F = r.normal(size=(100, k))
    Y600 = np.vstack([Y, (F @ L.T + noise * r.normal(size=(100, L.shape[0])))
                      .astype(np.float32)])
    L2 = np.vstack([L, (r.normal(size=(g2 * P - L.shape[0], k))
                        / np.sqrt(k)).astype(np.float32)])
    F = r.normal(size=(Y.shape[0], k))
    Y2 = (F @ L2.T + noise * r.normal(size=(Y.shape[0], L2.shape[0]))
          ).astype(np.float32)
    return Y600, Y2, L2


def recorded_phase(torch, dt, cuda_lib, card: str, Y, L, noise,
                   work: str) -> dict:
    """(15a) the recorded fit and (15b) the profiled one; (15d) the
    backend switch.  Returns the fits' launches, the donor checkpoint and
    the digest."""
    from dcfm_tpu_torch.obs import overlap_fraction, run_events
    from dcfm_tpu_torch.obs.cli import summarize
    from dcfm_tpu_torch.obs.metrics import default_registry
    from dcfm_tpu_torch.obs.spans import write_chrome_trace
    kernels = FIT_PATHS[0][3]
    c = FIT
    total = c["burnin"] + c["mcmc"]
    sweeps = c["chains"] * total
    os.environ.pop("DCFM_OBS_DIR", None)
    ck = os.path.join(work, "outer.npz")
    obs_a = os.path.join(work, "outer_events")
    ck_auto = os.path.join(work, "outer_auto.npz")
    ck_off = os.path.join(work, "outer_off.npz")
    fits, launches, rates = {}, {}, {"on": [], "off": []}
    # warm-up: a short fit of the same path and width, so that no timed fit
    # pays a first-use cost (as fit_phase does); then off and on in turns
    dt.fit(Y, outer_config(dt, run={"burnin": 2, "mcmc": 2}, obs="off"))
    for label, cfg in (
            ("off", outer_config(dt, checkpoint_path=ck_off, obs="off")),
            ("recorded", outer_config(dt, checkpoint_path=ck, obs=obs_a)),
            ("auto", outer_config(dt, checkpoint_path=ck_auto)),
            ("off again", outer_config(dt, checkpoint_path=ck_off,
                                       obs="off"))):
        with FsyncLog() as fs:
            res, got, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
        check_fit(torch, res, got, f"(15a) {label}", kernels, Y, L, noise)
        fits[label], launches[f"recorded fit ({label})"] = res, got
        rate = sweeps / res.phase_seconds["chain_s"]
        rates["off" if label.startswith("off") else "on"].append(rate)
        say(f"(15a) [{label}]: {sweeps} sweeps in "
            f"{res.phase_seconds['chain_s']:.4f} s chain time = "
            f"{rate:.2f} chain iterations/s, wall {wall:.3f} s, "
            f"checkpoint_s {res.phase_seconds['checkpoint_s']:.4f}, "
            f"{fs.count} durable flushes in {fs.seconds:.6f} s; "
            f"events_path {res.events_path}; {card}")
        if label in ("recorded", "auto"):
            check(fs.count == total // CKPT_CHUNK, f"(15a) {fs.count} "
                  f"fsyncs, expected one per boundary")
    on, off = np.mean(rates["on"]), np.mean(rates["off"])
    say(f"(15a) chain iterations/s recorded {on:.2f} (mean of "
        f"{len(rates['on'])}), not recorded {off:.2f} (mean of "
        f"{len(rates['off'])}): {on / off - 1:+.4f}; {card}")
    digest = sigma_digest(fits["recorded"].Sigma)
    check(all(sigma_digest(f.Sigma) == digest for f in fits.values()),
          "(15a) recording changed Sigma's bits")
    check(fits["recorded"].events_path == os.path.abspath(obs_a)
          and fits["auto"].events_path == os.path.abspath(ck_auto + ".obs")
          and fits["off"].events_path is None
          and not os.path.exists(ck_off + ".obs"),
          "(15a) events_path: " + str([f.events_path
                                        for f in fits.values()]))
    evs = run_events(obs_a)
    kinds = [e["event"] for e in evs]
    chunks = [e for e in evs if e["event"] == "chunk"]
    saves = [e["iteration"] for e in evs if e["event"] == "checkpoint_save"]
    say(f"(15a) events: {len(evs)} - " + json.dumps(
        {k: kinds.count(k) for k in dict.fromkeys(kinds)}))
    check(kinds[0] == "fit_start" and kinds[-1] == "fit_done",
          f"(15a) first/last events {kinds[0]}, {kinds[-1]}")
    check([e["decision"] for e in evs if e["event"] == "resume_decision"]
          == ["fresh"], "(15a) resume decisions")
    check(len(chunks) == total // CKPT_CHUNK
          and sum(e["end"] - e["start"] for e in chunks) == total
          and all(e["dur_s"] > 0 for e in chunks), "(15a) chunk events")
    check("stream_snapshot" in kinds and "stream_drain" in kinds,
          "(15a) no stream events")
    check(saves and max(saves) == total, f"(15a) saves at {saves}")
    check(evs[-1]["stream"] == fits["recorded"].stream_stats,
          "(15a) fit_done's stream summary is not FitResult.stream_stats")
    reg = default_registry()
    it_g = reg.gauge("dcfm_fit_iteration").value()
    ch_g = reg.gauge("dcfm_fit_chunk_seconds").value()
    check(it_g == total and ch_g > 0, f"(15a) gauges {it_g}, {ch_g}")
    trace = os.path.join(work, "outer_trace.json")
    write_chrome_trace(evs, trace)
    with open(trace) as f:
        slices = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    s = summarize(obs_a)
    check(s["chunks"] == len(chunks) and s["checkpoint_saves"] == len(saves)
          and s["last_checkpoint_iteration"] == saves[-1],
          f"(15a) summarize: {s}")
    nbytes = sum(os.path.getsize(os.path.join(obs_a, f))
                 for f in os.listdir(obs_a))
    say(f"(15a) event log {nbytes} bytes; saves at {saves}; gauges "
        f"iteration {it_g}, chunk_seconds {ch_g:.4f}; Chrome trace "
        f"{len(slices)} slices; overlap_fraction "
        f"{overlap_fraction(evs)}; summarize: {s['chunks']} chunks, "
        f"{s['checkpoint_saves']} saves, phases {s['phases']}")

    # (15d) the backend switch (before 15b: its fit is 15b's yardstick)
    cfg = outer_config(dt, obs="off", backend={"backend": "torch_cuda"})
    d, got, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
    check_path_launches(got, sweeps, "(15d) torch_cuda")
    launches["backend torch_cuda"] = got
    check(d.device.startswith("cuda"), f"(15d) backend='torch_cuda' ran "
          f"on {d.device}")
    check(sigma_digest(d.Sigma) == digest,
          "(15d) backend='torch_cuda' is not the default fit's bits")
    rate_d = sweeps / d.phase_seconds["chain_s"]
    for bad, device in (("torch_cuda", "cpu"), ("torch_cpu", "cuda"),
                        ("jax_tpu", None)):
        bad_cfg = outer_config(dt, obs="off", backend={"backend": bad})
        torch.cuda.synchronize()
        mem, n0 = torch.cuda.memory_allocated(), cuda_lib.launch_counts()
        t = time.perf_counter()
        try:
            dt.fit(Y, bad_cfg, device=device)
            fail(f"(15d) backend={bad!r}, device={device!r} did not raise")
        except ValueError as e:
            msg = str(e)
        check(torch.cuda.memory_allocated() == mem
              and cuda_lib.launch_counts() == n0,
              f"(15d) backend={bad!r} touched the card before refusing")
        say(f"(15d) backend={bad!r} device={device!r}: ValueError after "
            f"{time.perf_counter() - t:.4f} s, no card work ({msg})")
    say(f"(15d) backend='torch_cuda': Sigma = the default fit's bits; "
        f"{rate_d:.2f} chain iterations/s; {card}")

    # (15b) profile_dir
    prof_dir = os.path.join(work, "outer_profile")
    cfg = outer_config(dt, obs="off", backend={"profile_dir": prof_dir})
    prof, got, wall = counted_fit(torch, dt, cuda_lib, cfg, Y)
    check_path_launches(got, sweeps, "(15b) profiled")
    launches["profiled fit"] = got
    check(sigma_digest(prof.Sigma) == digest,
          "(15b) the profiler changed Sigma's bits")
    files = [f for f in os.listdir(prof_dir) if f.endswith(".json")]
    check(len(files) == 1, f"(15b) trace files {files}")
    path = os.path.join(prof_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = sum(1 for k in names if K1_NAME.search(k))
    k5 = sum(1 for k in names if K5_NAME.search(k))
    trips = sum(1 for e in events if e.get("name") == "trip"
                and e.get("cat") == "user_annotation")
    check(k1 > 0 and k5 > 0, f"(15b) K1 ({k1}) or K5 ({k5}) missing from "
          "the trace's kernels: " + str(sorted(set(names))[:40]))
    check(k1 == k5 == sweeps, f"(15b) the trace holds {k1} K1 and {k5} K5 "
          f"kernels, expected one each per sweep ({sweeps})")
    rate_p = sweeps / prof.phase_seconds["chain_s"]
    say(f"(15b) profiled fit: {rate_p:.2f} chain iterations/s (unprofiled "
        f"{rate_d:.2f}: overhead {rate_d / rate_p - 1:+.4f}), wall "
        f"{wall:.3f} s; trace {os.path.getsize(path)} bytes, "
        f"{len(names)} kernel events ({k1} K1, {k5} K5, {len(set(names))} "
        f"names), {trips} trip ranges ({prof.graphs['replays']} replays); "
        f"Sigma = (a)'s bits; {card}")
    return {"launches": launches, "donor": ck, "digest": digest}


def warm_phase(torch, dt, cuda_lib, card: str, Y, L, noise, work: str,
               donor: str) -> dict:
    """(15c) warm starts from (15a)'s checkpoint (2 chains at iteration
    400): appended rows, new shards, graph == eager for one chunk, a K = 4
    donor's cold start, a warm refit killed and resumed."""
    import functools

    from dcfm_tpu_torch import api
    from dcfm_tpu_torch.config import WarmStart
    from dcfm_tpu_torch.models import sampler
    c = FIT
    g = c["g"]
    sweeps = c["chains"] * sum(OUTER_WARM_RUN.values())
    Y600, Y72, L72 = warm_data(Y, L, noise, g + 8)
    launches = {}
    for label, Yw, Lw, model in (("appended rows", Y600, L, {}),
                                 ("new shards", Y72, L72,
                                  {"num_shards": g + 8})):
        obs = os.path.join(work, f"warm_{model.get('num_shards', g)}")
        with InitialStates() as init:
            warm, got, wall = counted_fit(torch, dt, cuda_lib, outer_config(
                dt, run=OUTER_WARM_RUN, model=model, obs=obs,
                warm_start=WarmStart(donor)), Yw)
        check_path_launches(got, sweeps, f"(15c) warm, {label}")
        launches[f"warm, {label}"] = got
        (ev,) = outer_events(obs, "warm_start")
        check(ev["decision"] == "warm", f"(15c) {label}: decision {ev}")
        lam, ps = init.leaves(0), init.leaves(3)
        d_lam, d_ps = donor_leaf(donor, 0), donor_leaf(donor, 3)
        check(np.array_equal(lam[:, :g], d_lam)
              and np.array_equal(ps[:, :g], d_ps),
              f"(15c) {label}: the first {g} shards' Lambda / psi are not "
              "the donor's bytes")
        cold, got, _ = counted_fit(torch, dt, cuda_lib, outer_config(
            dt, run=OUTER_WARM_RUN, model=model, obs="off"), Yw)
        check_path_launches(got, sweeps, f"(15c) cold, {label}")
        err, err_s = truth_errors(torch, warm.Sigma, Yw, Lw, noise)
        err_c, _ = truth_errors(torch, cold.Sigma, Yw, Lw, noise)
        say(f"(15c) {label} {Yw.shape}: decision warm, {ev['leaves']} "
            f"leaves grafted, {ev['verbatim_leaves']} verbatim, donor "
            f"iteration {ev['donor_iteration']}, relineage "
            f"{ev['relineage']}; rel Frobenius warm {err:.6f}, cold "
            f"{err_c:.6f} (same {OUTER_WARM_RUN} schedule), sample "
            f"covariance {err_s:.6f}; warm "
            f"{sweeps / warm.phase_seconds['chain_s']:.2f} chain "
            f"iterations/s, init_s {warm.phase_seconds['init_s']:.4f}; "
            f"{card}")
        check(err < 0.25 and err <= 2 * err_s,
              f"(15c) {label}: warm rel Frobenius {err:.4f} (sample "
              f"{err_s:.4f})")
        del warm, cold

    # graph == eager on warm-started chains, one chunk
    one = outer_config(dt, run={"burnin": 20, "mcmc": 30}, obs="off",
                       warm_start=WarmStart(donor))
    graphed = dt.fit(Y600, one)
    runner = api.ChainRunner
    api.ChainRunner = functools.partial(runner, graphs=False)
    try:
        eager = dt.fit(Y600, one)
    finally:
        api.ChainRunner = runner
    check(graphed.graphs["replays"] > 0 and eager.graphs["replays"] == 0,
          f"(15c) graphs {graphed.graphs} / {eager.graphs}")
    same = (sigma_digest(graphed.Sigma) == sigma_digest(eager.Sigma)
            and state_digest(graphed.state) == state_digest(eager.state))
    say(f"(15c) graph == eager on 2 warm-started chains, one chunk of 50: "
        f"Sigma and state {'bitwise' if same else 'DIFFER'}; graphs "
        f"{json.dumps(graphed.graphs)}")
    check(same, "(15c) the graphed warm chain is not the eager one")

    # a K = 4 donor: a recorded cold start from a plain fit's state
    ck4 = os.path.join(work, "outer_k4.npz")
    short = {"burnin": 4, "mcmc": 4}
    dt.fit(Y, outer_config(dt, run=short, model={"factors_per_shard": 4},
                           obs="off", checkpoint_path=ck4))
    obs4 = os.path.join(work, "warm_k4")
    with InitialStates() as cold_init:
        dt.fit(Y, outer_config(dt, run=short, obs=obs4,
                               warm_start=WarmStart(ck4)))
    with InitialStates() as plain_init:
        dt.fit(Y, outer_config(dt, run=short, obs="off"))
    (ev,) = outer_events(obs4, "warm_start")
    check(ev["decision"] == "cold" and ev["reason"] == (
        "donor model config differs beyond num_shards - the state pytrees "
        "are not graft-compatible"), f"(15c) K = 4 donor: {ev}")
    check([e["decision"] for e in outer_events(obs4, "resume_decision")]
          == ["fresh"], "(15c) K = 4 donor: no fresh decision")
    check(cold_init.digest() == plain_init.digest(),
          "(15c) the cold fallback's initial state is not a plain fit's")
    say(f"(15c) K = 4 donor: decision cold ({ev['reason']}); initial "
        "state bitwise a plain fit's of the same seed")

    # a warm refit killed mid-run in a child and resumed in a fresh one
    kpath = os.path.join(work, "warm_killed.npz")
    fit_kw = {"checkpoint_path": kpath, "checkpoint_every_chunks": 1,
              "warm_start": {"checkpoint": donor}}
    ref = dt.fit(Y, outer_config(
        dt, run=WARM_KILL_RUN, obs="off", checkpoint_every_chunks=1,
        checkpoint_path=os.path.join(work, "warm_ref.npz"),
        warm_start=WarmStart(donor)))
    spec = {"path": "f32", "run": WARM_KILL_RUN,
            "backend": {"fetch_dtype": "quant8"},
            "fit": dict(fit_kw, permute=False,
                        obs=os.path.join(work, "warm_kill_1"))}
    total = sum(WARM_KILL_RUN.values())
    killed = run_child(spec, work, "warm_killed", kill_at=KILL_AT,
                       path=kpath)["killed_at"]
    from dcfm_tpu_torch.utils.checkpoint import read_checkpoint_meta
    check(read_checkpoint_meta(kpath)["iteration"] < total,
          "(15c) the killed warm refit's file reached the end")
    out = run_child(dict(spec, fit=dict(
        spec["fit"], resume=True, obs=os.path.join(work, "warm_kill_2"))),
        work, "warm_resumed")
    first = outer_events(os.path.join(work, "warm_kill_1"), "warm_start")
    second = outer_events(os.path.join(work, "warm_kill_2"),
                          "resume_decision")
    check([e["decision"] for e in first] == ["warm"]
          and [e["decision"] for e in second] == ["resume"]
          and not outer_events(os.path.join(work, "warm_kill_2"),
                               "warm_start"),
          f"(15c) kill: decisions {first} / {second}")
    check(out["sigma"] == sigma_digest(ref.Sigma)
          and out["executed"] == total - second[0]["iteration"],
          "(15c) the resumed warm refit is not the uninterrupted one's bits")
    say(f"(15c) warm refit SIGKILLed with its file at iteration {killed}, "
        f"resumed in a fresh process at {second[0]['iteration']} (decision "
        f"resume, no re-graft): Sigma bitwise the uninterrupted warm "
        f"refit's; {card}")
    return launches


def outer_phase(torch, dt, cuda_lib, card: str, Y, L, noise,
                work: str) -> dict:
    """(15) the outer layers at the north-star width.  Returns the
    launches of each of its fits."""
    t0 = time.perf_counter()
    a = recorded_phase(torch, dt, cuda_lib, card, Y, L, noise, work)
    say(f"(15a, b, d) done in {time.perf_counter() - t0:.1f} s")
    launches = dict(a["launches"])
    launches.update(warm_phase(torch, dt, cuda_lib, card, Y, L, noise,
                               work, a["donor"]))
    say(f"(15c) done in {time.perf_counter() - t0:.1f} s")
    return launches


def k3_path(torch, bs, cuda_lib, rng) -> dict:
    """K3's launches: one call of its public op at the fit's batch, the
    counters zeroed just before and read just after."""
    dev = torch.device("cuda")
    Q = torch.as_tensor(spd(rng.standard_normal((FULL_B, FULL_K, FULL_K),
                                                np.float32)), device=dev)
    b = torch.as_tensor(rng.standard_normal((FULL_B, FULL_K), np.float32),
                        device=dev)
    cuda_lib.reset_launch_counts()
    x = bs.cho_solve_batched(Q, b)
    torch.cuda.synchronize()
    launches = cuda_lib.launch_counts()
    check(bool(torch.isfinite(x).all()), "cho_solve_batched: non-finite")
    check(launches["cho_solve"] == 1, f"cho_solve_batched launched "
          f"{launches}")
    return launches


def sweep_profile(torch, cfg, Y, card: str, label: str,
                  rows_out: list | None = None) -> float:
    """Device busy ms per sweep of one graphed chain at the fit's save mix
    (printed with the host ms and the top kernels); ``rows_out`` receives
    every kernel's (name, us per sweep)."""
    from torch.profiler import ProfilerActivity, profile

    from dcfm_tpu_torch.api import CUDA_AUTO_UNROLL
    from dcfm_tpu_torch.models.sampler import ChainRunner
    from dcfm_tpu_torch.noise import TorchNoise
    m, Yd, prior = chain_setup(torch, cfg, Y)
    # thin 4: one sweep in four accumulates, the fit's mix (200 burn-in +
    # 200 kept at thin 2); windows of 48 sweeps meet the same patterns
    runner = ChainRunner(TorchNoise(0, "cuda"), Yd, m, prior, burnin=0,
                         thin=4, unroll=CUDA_AUTO_UNROLL)
    carry = runner.init_chain(0)
    n = 48

    def window():
        runner.run_chunk(0, carry, n)

    window()                               # warm-up: eager trips, captures
    window()
    torch.cuda.synchronize()
    t = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t) * 1e3 / n
    busy, rows = device_busy_ms(prof)
    busy /= n
    # the profiler slows the host, so idle is read against the unprofiled
    # window's wall (and, for reference, the profiled one's)
    say(f"sweep [{label}] (graphed, T={CUDA_AUTO_UNROLL}, "
        f"{runner.captured} graphs): {wall:.3f} ms per sweep on the host "
        f"clock ({wall_prof:.3f} ms under the profiler); device busy "
        + (f"{busy:.3f} ms per sweep, idle {1 - busy / wall:.1%} of the "
           f"unprofiled wall ({1 - busy / wall_prof:.1%} of the profiled)"
           if busy > 0 else
           "not measured (the profiler recorded no device time)")
        + f"; {card}")
    for name, ms in rows[:12]:
        say(f"  {ms / n * 1e3:9.2f} us/sweep  {name[:160]}")
    if rows_out is not None:
        rows_out.extend((name, ms / n * 1e3) for name, ms in rows)
    del runner, carry
    torch.cuda.empty_cache()
    return busy


def _solver(div: str, sample: str) -> str:
    """Which kernel an instantiation of chol_group_kernel serves."""
    return "K1" if div == "0" else "K4" if sample == "1" else "K3"


def _loads(vec: str) -> str:
    return "float4 loads" if vec == "1" else "scalar loads"


# the templated kernels by their mangled names: (pattern, label of one
# instantiation from the pattern's groups, (kernel, K) of that instantiation)
KERNEL_FAMILIES = (
    (r"chol_group_kernelILi(\d+)ELi(\d+)ELb([01])ELb([01])ELb([01])E",
     lambda K, T, div, sample, vec:
         f"chol_group_kernel K={int(K):2d} T={T} {_solver(div, sample)} "
         f"({'divide' if div == '1' else 'multiply'}"
         f"{'' if sample == '1' else ', no noise chain'}), {_loads(vec)}",
     lambda K, T, div, sample, vec: (_solver(div, sample), int(K))),
    (r"lam_rows_kernelILi(\d+)ELi(\d+)ELb([01])E",
     lambda K, T, vec: f"lam_rows_kernel K={int(K):2d} T={T} K2, {_loads(vec)}",
     lambda K, T, vec: ("K2", int(K))),
    (r"sse_ps_fixedILi(\d+)ELb([01])ELi(\d+)E",
     lambda K, vec, T: f"sse_ps_fixed K={int(K):2d} T={T} K5, {_loads(vec)}",
     lambda K, vec, T: ("K5", int(K))),
    (r"sse_ps_anyILi(\d+)E",
     lambda T: f"sse_ps_any any K T={T} K5 (the K > 16 route), scalar loads",
     lambda T: ("K5", 0)),
    (r"floor_empty_kernel", lambda: "floor_empty_kernel (no port)",
     lambda: ("floor", 0)),
    (r"floor_pass_kernelILi(\d+)ELi(\d+)E",
     lambda per, T: f"floor_pass_kernel K={4 * int(per):2d} T={T} (no port), "
                    "float4 loads",
     lambda per, T: ("floor", int(per))),
)


def kernel_report(log: str) -> None:
    """The ptxas registers and spills of every instantiation of the
    templated kernels (the lane-group kernel of K1, K4 and K3, K2's
    loader, K5's fixed-K and any-K kernels), one line each; fails on a
    spill, or if a kernel lacks an instantiation for a K of 1..16."""
    seen, spilled, name, spill = set(), [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), None
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and spill is None:           # the entry's own, listed first
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if not (m and name and spill is not None):
            continue
        for pattern, label, key in KERNEL_FAMILIES:
            g = re.search(pattern, name)
            if g:
                seen.add(key(*g.groups()))
                say(f"{label(*g.groups())}: {m.group(1)} registers, spill "
                    f"stores {spill[0]} B, spill loads {spill[1]} B")
                if spill[0] or spill[1]:
                    spilled.append(label(*g.groups()))
        name = None
    missing = [(k, K) for k in ("K1", "K4", "K3", "K2", "K5")
               for K in range(1, 17) if (k, K) not in seen]
    if ("K5", 0) not in seen:
        missing.append(("K5", "any K"))
    check(not missing, f"ptxas reports no kernel for {missing}")
    check(not spilled, f"kernels spill: {spilled}")


def sass_report(cuda_lib, lib_path: str) -> None:
    """Static SASS instruction counts of the K = 8 float4 instantiation of
    every templated kernel (the fit's shape), from cuobjdump: the body up
    to its unpredicated EXIT, which is straight-line code (every loop is
    unrolled), so it is what each warp executes; the out-of-line slow paths
    of division and square root behind the EXIT are counted apart."""
    exe = os.path.join(os.path.dirname(cuda_lib.nvcc_path()), "cuobjdump")
    if not os.path.exists(exe):
        say("sass: cuobjdump not found beside nvcc; instruction counts not "
            "measured")
        return
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                         text=True, timeout=600)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr.strip()}")
    want = {"chol_group_kernelILi8ELi128ELb0ELb1ELb1E": "K1",
            "chol_group_kernelILi8ELi128ELb1ELb1ELb1E": "K4",
            "chol_group_kernelILi8ELi128ELb1ELb0ELb1E": "K3",
            "lam_rows_kernelILi8ELi128ELb1E": "K2",
            "sse_ps_fixedILi8ELb1ELi128E": "K5"}
    label, body, rest, by, done = None, 0, 0, {}, False

    def flush():
        if label:
            mix = ", ".join(f"{k} {by[k]}" for k in sorted(by, key=by.get,
                                                            reverse=True)[:6])
            say(f"sass {label} K=8: {body} instructions to the EXIT ({mix}), "
                f"{rest} behind it")

    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            flush()
            label = next((v for k, v in want.items() if k in m.group(1)),
                         None)
            body, rest, by, done = 0, 0, {}, False
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(@!?U?P\d+\s+)?([A-Z][A-Z0-9_]*)",
                     line)
        if not (label and m) or m.group(2) == "NOP":
            continue
        if done:
            rest += 1
            continue
        body += 1
        by[m.group(2)] = by.get(m.group(2), 0) + 1
        done = m.group(2) == "EXIT" and not m.group(1)
    flush()


# -- step 16: the serving plane on the card ---------------------------------

SERVE_P5 = dict(g=256, P=196)           # BASELINE config 5's width
SERVE_DEVICE = "cuda"                   # where step 16's engines run
SERVE_C5_CACHE_MB = 1024                # config 5's cache: < its panels


def serve_fit(dt, Y, seed: int):
    """A short posterior-SD quant8 fit of the north-star width (the f32
    path): the artifact step 16 serves."""
    label, model, backend, _ = FIT_PATHS[0]
    cfg = path_config(dt, model | {"posterior_sd": True},
                      backend | {"fetch_dtype": "quant8"})
    return dt.fit(Y, dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, burnin=20, mcmc=20,
                                     seed=seed)))


def perturbed_copy(src: str, dst: str, pairs) -> str:
    """``src`` copied with ``pairs``' mean panels XOR-perturbed (diagonal
    pairs stay symmetric), its CRCs and fingerprint re-recorded: a
    candidate whose change is localized, as a delta is for."""
    import shutil

    from dcfm_tpu_torch.serve.artifact import (
        artifact_fingerprint, panel_crc32)
    shutil.copytree(src, dst)
    with open(os.path.join(dst, "meta.json"), encoding="utf-8") as f:
        meta = json.load(f)
    n_pairs = meta["g"] * (meta["g"] + 1) // 2
    q = np.memmap(os.path.join(dst, "mean_q8.bin"), dtype=np.int8,
                  mode="r+", shape=(n_pairs, meta["P"], meta["P"]))
    for pair in pairs:
        q[pair] ^= 0x55
    q.flush()
    meta["panel_crc"]["mean"] = [int(panel_crc32(np.asarray(p))) for p in q]
    del q
    meta["fingerprint"] = artifact_fingerprint(meta)
    with open(os.path.join(dst, "meta.json"), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    return dst


def serve_proc(args: list, env: dict | None = None):
    """``python -m dcfm_tpu_torch.cli serve ...`` from this checkout; returns
    (process, its startup JSON line)."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=dict(os.environ, **(env or {})))
    line = proc.stdout.readline()
    if not line:
        proc.kill()
        fail(f"serve {args} printed no startup line: "
             f"{proc.communicate()[1][-3000:]}")
    return proc, json.loads(line)


def stop_proc(proc, label: str) -> str:
    """SIGTERM, a bounded drain, exit 0; returns the last stdout line."""
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"[{label}] did not drain within 120 s of SIGTERM")
    check(proc.returncode == 0, f"[{label}] exited {proc.returncode}: "
          f"{err[-3000:]}")
    last = json.loads(out.strip().splitlines()[-1])
    check(last.get("drained") is True, f"[{label}] last line {last}")
    return last


def http_json(conn, path: str) -> tuple:
    """One GET on a persistent connection: (status, body, headers)."""
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, json.loads(r.read()), dict(r.getheaders())


def bits_of(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def http_bitwise(base: str, refs: dict, rng, n_entries: int,
                 n_blocks: int, n_rows: int, n_intervals: int,
                 threads: int = 32) -> dict:
    """Seeded entries, blocks, full rows and intervals over HTTP (one
    persistent connection per client thread), every answer held to the
    offline assembly bit for bit; returns counts and seconds."""
    import http.client
    import threading

    from dcfm_tpu_torch.serve.engine import _norm_ppf
    mean, sd = refs["mean"], refs["sd"]
    p = mean.shape[0]
    jobs = [("entry", int(i), int(j)) for i, j in
            rng.integers(0, p, (n_entries, 2))]
    for _ in range(n_blocks):
        rows = rng.integers(0, p, int(rng.integers(1, 40)))
        lo = int(rng.integers(0, p - 64))
        jobs.append(("block", rows, np.arange(lo, lo + 64)))
    jobs += [("row", int(i), None) for i in rng.integers(0, p, n_rows)]
    jobs += [("interval", int(i), int(j)) for i, j in
             rng.integers(0, p, (n_intervals, 2))]
    z = _norm_ppf(1.0 - 0.05 / 2.0)
    host, port = base.split("//", 1)[1].rsplit(":", 1)
    bad, counts, lock = [], {}, threading.Lock()

    def run(part):
        conn = http.client.HTTPConnection(host, int(port), timeout=120)
        try:
            for kind, a, b in part:
                if kind == "entry":
                    st, body, _ = http_json(conn, f"/v1/entry?i={a}&j={b}")
                    ok = st == 200 and bits_of(body["value"]) == \
                        bits_of(mean[a, b])
                elif kind == "interval":
                    st, body, _ = http_json(conn,
                                            f"/v1/interval?i={a}&j={b}")
                    m, s = float(mean[a, b]), float(sd[a, b])
                    ok = (st == 200 and body["mean"] == m
                          and body["sd"] == s and body["lo"] == m - z * s
                          and body["hi"] == m + z * s)
                else:
                    rows = [a] if kind == "row" else list(a)
                    cols = (f"0:{p}" if kind == "row"
                            else f"{int(b[0])}:{int(b[-1]) + 1}")
                    st, body, _ = http_json(conn, "/v1/block?rows=" + ",".join(
                        str(int(r)) for r in rows) + f"&cols={cols}")
                    want = (mean[a] if kind == "row"
                            else mean[np.ix_(np.asarray(a), b)])
                    ok = st == 200 and np.array_equal(
                        bits_of(body["values"]).reshape(-1),
                        bits_of(want).reshape(-1))
                with lock:
                    counts[kind] = counts.get(kind, 0) + 1
                    if not ok:
                        bad.append((kind, a if kind != "block" else "...",
                                    st))
        finally:
            conn.close()

    order = rng.permutation(len(jobs))
    parts = [[jobs[k] for k in order[t::threads]] for t in range(threads)]
    pool = [threading.Thread(target=run, args=(part,)) for part in parts]
    t0 = time.perf_counter()
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=600)
    secs = time.perf_counter() - t0
    check(not any(t.is_alive() for t in pool), "bitwise clients hung")
    check(not bad, f"{len(bad)} answers differ from assemble(): {bad[:5]}")
    check(sum(counts.values()) == len(jobs), f"answered {counts} of "
          f"{len(jobs)}")
    return {"counts": counts, "seconds": secs}


def load_report(res: dict, card: str, label: str) -> None:
    """A run_load result's numbers, and its classification checks."""
    check(res["untyped"] == [], f"[{label}] untyped answers: "
          f"{res['untyped'][:3]}")
    check(res["dropped"] == 0, f"[{label}] {res['dropped']} dropped")
    check(res["value_errors"] == [], f"[{label}] value errors: "
          f"{res['value_errors'][:3]}")
    check(res["generation"]["violations"] == 0,
          f"[{label}] generation regressions: {res['generation']}")
    routes = ", ".join(
        f"{k} {v['requests']} requests p50 {v['p50_ms']} ms p99 "
        f"{v['p99_ms']} ms" for k, v in res["by_route"].items())
    say(f"(16) [{label}] {res['requests']} requests in "
        f"{res['elapsed_s']} s = {res['qps']} requests/s (p50 "
        f"{res['p50_ms']} ms, p99 {res['p99_ms']} ms); {routes}; ok "
        f"{res['ok']}, typed {res['typed']}, untyped 0, dropped 0, retries "
        f"{res['retries']}, generations {res['generation']}; {card}")


def fleet_events(run_dir: str, kind: str) -> list:
    from dcfm_tpu_torch.obs.recorder import read_events
    path = os.path.join(run_dir, "events-fleet.jsonl")
    if not os.path.exists(path):
        return []
    return [e for e in read_events(path) if e["event"] == kind]


def await_events(run_dir: str, kind: str, n: int,
                 timeout: float = 180.0) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = fleet_events(run_dir, kind)
        if len(got) >= n:
            return got
        time.sleep(0.05)
    fail(f"the fleet recorded fewer than {n} {kind} events")


def serve_phase(torch, dt, cuda_lib, card: str, Y, work: str) -> None:
    """(16) The serving plane on the card: (a) a north-star artifact with
    SD panels; (b) ``cli serve`` on the card - every answer of a seeded
    set bitwise ``assemble()``, a 64-thread load, the warm cache's device
    bytes; (c) config 5's width under a 1 GiB cache, every answer bitwise
    a CPU engine's; (d) a full and a delta hot swap under load; (e) a
    2-worker fleet, a worker SIGKILLed under load, respawned, drained;
    (f) no Gibbs kernel launched by the serving path."""
    import threading
    import urllib.parse

    from dcfm_tpu_torch.serve.artifact import (
        PosteriorArtifact, create_sparse_artifact, export_fit_result)
    from dcfm_tpu_torch.serve.delta import write_delta_artifact
    from dcfm_tpu_torch.serve.engine import QueryEngine, _norm_ppf
    from dcfm_tpu_torch.serve.loadgen import run_load
    from dcfm_tpu_torch.serve.promote import promote_artifact, promote_delta
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    say(f"(16) at entry: allocated {torch.cuda.memory_allocated()} B, "
        f"reserved {torch.cuda.memory_reserved()} B; {card}")
    # (a) the artifacts: generation 1 and 2 from two fits, generation 3 a
    # delta against 2 (64 mean panels changed)
    root = os.path.join(work, "serve_root")
    stage = os.path.join(work, "serve_stage")
    os.makedirs(root)
    os.makedirs(stage)
    t = time.perf_counter()
    for seed, path in ((0, os.path.join(root, "v1")),
                       (1, os.path.join(stage, "v2"))):
        res = serve_fit(dt, Y, seed)
        check(res.Sigma_sd is not None, "(16a) the fit has no SD")
        export_fit_result(res, path)
        del res
    n_pairs = FIT["g"] * (FIT["g"] + 1) // 2
    changed = tuple(range(0, n_pairs, n_pairs // 64))[:64]
    perturbed_copy(os.path.join(stage, "v2"), os.path.join(stage, "v3"),
                   changed)
    d = write_delta_artifact(os.path.join(stage, "v3"),
                             PosteriorArtifact.open(os.path.join(
                                 stage, "v2")),
                             os.path.join(root, "v3.delta"))
    import shutil
    shutil.copytree(os.path.join(stage, "v2"), os.path.join(root, "v2"))
    arts = {g: PosteriorArtifact.open(p) for g, p in (
        (1, os.path.join(root, "v1")), (2, os.path.join(root, "v2")),
        (3, os.path.join(stage, "v3")))}
    a1 = arts[1]
    check((a1.g, a1.p_original, a1.has_sd, a1.n_pairs)
          == (FIT["g"], FIT["p"], True, n_pairs),
          f"(16a) artifact shape {(a1.g, a1.P, a1.p_original)}")
    refs = {g: {"mean": a.assemble(), "sd": a.assemble(kind="sd")}
            for g, a in arts.items()}
    say(f"(16a) two fits at p={FIT['p']}, g={FIT['g']}, K={FIT['K']}, "
        f"{FIT['chains']} chains (20 + 20 "
        f"sweeps, posterior SD, quant8) exported, a delta of "
        f"{d.panels_changed} panels ({d.bytes_shipped} of {d.full_bytes} "
        f"bytes) and three references assembled in "
        f"{time.perf_counter() - t:.1f} s; {card}")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cuda_lib.reset_launch_counts()
    # (b) one server on the card
    promote_artifact(root, "v1")
    obs = os.path.join(work, "serve_obs")
    t = time.perf_counter()
    proc, info = serve_proc([root, "--port", "0", "--cache-mb", "1024",
                             "--max-queue", "4096", "--request-timeout",
                             "60", "--swap-poll", "0.05", "--device",
                             SERVE_DEVICE], {"DCFM_OBS_DIR": obs})
    try:
        base = info["serving"]
        label = (f"cuda:0 ({torch.cuda.get_device_name(0)})"
                 if SERVE_DEVICE == "cuda" else SERVE_DEVICE)
        check(info["device"] == label, f"(16b) {info}")
        import urllib.request
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            h = json.loads(r.read())
        check(h["device"] == label and h["status"] == "ok",
              f"(16b) /healthz {h}")
        say(f"(16b) serve on the card up in {time.perf_counter() - t:.2f} s "
            f"(interpreter, torch, CUDA, artifact), /healthz device "
            f"{h['device']!r}; {card}")
        rng = np.random.default_rng(16)
        got = http_bitwise(base, refs[1], rng, 20_000, 50, 20, 200)
        say(f"(16b) {got['counts']} answers bitwise assemble() (mean and "
            f"SD) in {got['seconds']:.2f} s over 32 keep-alive clients; "
            f"{card}")
        res = run_load(base, threads=64, requests_per_thread=100, seed=16,
                       p=a1.p_original, retries=2, timeout=60.0)
        load_report(res, card, "64-thread load, north star")
        with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
            m = json.loads(r.read())
        lat = {k: (v.get("p50_ms"), v.get("p99_ms"))
               for k, v in m["latency"].items()}
        say(f"(16b) server side: statuses {m['statuses']}, cache "
            f"{m['cache']}, batcher max batch "
            f"{m['batcher']['max_batch_seen']}, p50/p99 ms by route "
            f"{lat}; {card}")
        check(not any(s.startswith("5") and s != "503"
                      for s in m["statuses"]), f"(16b) 5xx: {m['statuses']}")
        # the warm cache's device bytes, in process
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        eng = QueryEngine(a1, cache_bytes=1 << 30, device=SERVE_DEVICE)
        keys = [(k, pr) for k in ("mean", "sd") for pr in range(a1.n_pairs)]
        t = time.perf_counter()
        check(eng.prewarm(keys) == 2 * a1.n_pairs, "(16b) prewarm")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        st = eng.stats()
        grown = torch.cuda.memory_allocated() - before
        want = 2 * a1.n_pairs * a1.P * a1.P * 4
        check(st["bytes"] == want and st["evictions"] == 0,
              f"(16b) warm cache {st}")
        check(grown >= st["bytes"], f"(16b) allocated grew {grown} B only")
        # the in-process engine's batched entries and blocks, bitwise
        r16 = np.random.default_rng(160)
        qs = [(int(i), int(j), True) for i, j in
              r16.integers(0, a1.p_original, (2000, 2))]
        check(np.array_equal(bits_of(eng.entries(qs)), bits_of(
            [refs[1]["mean"][i, j] for i, j, _ in qs])),
            "(16b) in-process entries differ from assemble()")
        for _ in range(10):
            rows = r16.integers(0, a1.p_original, 64)
            cols = r16.integers(0, a1.p_original, 64)
            check(np.array_equal(bits_of(eng.block(rows, cols, kind="sd")),
                                 bits_of(refs[1]["sd"][np.ix_(rows, cols)])),
                  "(16b) in-process SD block differs from assemble()")
        say(f"(16b) fully warm cache: {st['panels']} panels, "
            f"{st['bytes']} device bytes (reckoning {want:,} B = 2 x "
            f"{a1.n_pairs} x {a1.P}^2 x 4), memory_allocated +{grown} B, "
            f"reserved "
            f"{torch.cuda.memory_reserved()} B, warmed in {secs:.2f} s "
            f"({2 * a1.n_pairs / secs:.0f} panels/s: CRC, copy, dequant); "
            f"{card}")
        del eng
        torch.cuda.empty_cache()
        # (d) a full swap then a delta swap under a 64-thread storm
        seen, lock, swaps = {"n": 0}, threading.Lock(), {}
        z = _norm_ppf(1.0 - 0.05 / 2.0)

        def expect(kind, path, body, gen):
            with lock:
                seen["n"] += 1
                n = seen["n"]
            if n == 800:
                swaps["full"] = time.perf_counter()
                promote_artifact(root, "v2")
            elif n == 2400:
                swaps["delta"] = time.perf_counter()
                promote_delta(root, "v3.delta")
            ref = refs[gen]
            if kind == "healthz":
                return None
            q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
            if kind == "block":
                lo, hi = (int(v) for v in q["rows"][0].split(":"))
                return (None if np.array_equal(
                    bits_of(body["values"]),
                    bits_of(ref["mean"][lo:hi, lo:hi])) else f"block {gen}")
            i, j = int(q["i"][0]), int(q["j"][0])
            if kind == "interval":
                m, s = float(ref["mean"][i, j]), float(ref["sd"][i, j])
                ok = body["mean"] == m and body["sd"] == s \
                    and body["lo"] == m - z * s
                return None if ok else f"interval {gen} ({i},{j})"
            return (None if bits_of(body["value"]) == bits_of(
                ref["mean"][i, j]) else f"entry {gen} ({i},{j})")

        res = run_load(base, threads=64, requests_per_thread=60, seed=17,
                       p=a1.p_original, retries=2, timeout=60.0,
                       expect=expect)
        load_report(res, card, "hot swaps under load")
        check((res["generation"]["min"], res["generation"]["max"]) == (1, 3),
              f"(16d) generations {res['generation']}")
        last = stop_proc(proc, "serve")
        from dcfm_tpu_torch.obs import run_events
        sw = [e for e in run_events(obs) if e["event"] == "serve_swap"]
        check(len(sw) == 2 and sw[1]["panels_adopted"] == 2 * n_pairs - 64,
              f"(16d) swaps {sw}")
        for e in sw:
            say(f"(16d) swap to generation {e['generation']}: "
                f"{e['swap_s']:.4f} s in the server (verify all panels' "
                f"CRCs, build the engine, prewarm {e['prewarm_panels']} "
                f"panels), {e['panels_adopted']} panels adopted, "
                f"{e['cache_seeded']} device panels carried, "
                f"{e['bytes_shipped']} bytes shipped; {card}")
        say(f"(16b) drained: {last}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    # (c) config 5's width: 1,263,732,736 B of seeded mean panels
    g5, P5 = SERVE_P5["g"], SERVE_P5["P"]
    t = time.perf_counter()
    path5 = create_sparse_artifact(os.path.join(work, "c5"), g=g5, P=P5)
    n5 = g5 * (g5 + 1) // 2
    mm = np.memmap(os.path.join(path5, "mean_q8.bin"), dtype=np.int8,
                   mode="r+", shape=(n5, P5, P5))
    r5 = np.random.default_rng(5)
    for lo in range(0, n5, 2048):
        hi = min(n5, lo + 2048)
        mm[lo:hi] = np.frombuffer(r5.bytes((hi - lo) * P5 * P5),
                                  np.int8).reshape(hi - lo, P5, P5)
    mm.flush()
    del mm
    a5 = PosteriorArtifact.open(path5)
    b5 = os.path.getsize(os.path.join(path5, "mean_q8.bin"))
    check(b5 == n5 * P5 * P5, "(16c) config-5 panel bytes")
    say(f"(16c) config 5's artifact (p={g5 * P5:,}, g={g5}, P={P5}, {n5} "
        f"panels, {b5:,} B) filled in {time.perf_counter() - t:.1f} s; "
        f"{card}")
    cpu_eng = QueryEngine(a5, device="cpu", cache_bytes=512 << 20)
    proc, info = serve_proc([path5, "--port", "0", "--cache-mb",
                             str(SERVE_C5_CACHE_MB), "--max-queue", "4096",
                             "--request-timeout", "60", "--device",
                             SERVE_DEVICE])
    try:
        def expect5(kind, path, body, gen):
            q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
            if kind == "block":
                lo, hi = (int(v) for v in q["rows"][0].split(":"))
                want = cpu_eng.block(np.arange(lo, hi), np.arange(lo, hi))
                return (None if np.array_equal(bits_of(body["values"]),
                                               bits_of(want)) else "block")
            i, j = int(q["i"][0]), int(q["j"][0])
            want = cpu_eng.entry(i, j)
            return (None if bits_of(body["value"]) == bits_of(want)
                    else f"entry ({i},{j})")

        res = run_load(info["serving"], threads=64,
                       requests_per_thread=200, seed=18, p=g5 * P5,
                       retries=2, timeout=60.0, expect=expect5,
                       route_mix=(("entry", 6), ("block", 1)))
        load_report(res, card, "config 5, 1 GiB cache")
        import urllib.request
        with urllib.request.urlopen(info["serving"] + "/metrics",
                                    timeout=60) as r:
            st = json.loads(r.read())["cache"]
        check(st["evictions"] > 0
              and st["bytes"] <= SERVE_C5_CACHE_MB << 20,
              f"(16c) cache {st}")
        say(f"(16c) cache {st}, every one of {res['ok']} answers bitwise "
            f"the CPU engine's; {card}")
        stop_proc(proc, "serve config 5")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    del cpu_eng
    # (e) a 2-worker fleet on the one card; first, where a worker's
    # start-up goes, in a fresh process as a worker is one
    probe = subprocess.run(
        [sys.executable, "-c", "import time; t0 = time.perf_counter()\n"
         "import torch; t1 = time.perf_counter()\n"
         f"torch.zeros(1, device={SERVE_DEVICE!r}).cpu(); "
         "t2 = time.perf_counter()\n"
         "import dcfm_tpu_torch.serve.server; t3 = time.perf_counter()\n"
         "print(t1 - t0, t2 - t1, t3 - t2)"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    check(probe.returncode == 0, f"(16e) start-up probe: {probe.stderr}")
    t_torch, t_ctx, t_pkg = (float(v) for v in probe.stdout.split())
    say(f"(16e) a fresh process: import torch {t_torch:.3f} s, the first "
        f"device tensor (CUDA context) {t_ctx:.3f} s, import the serving "
        f"plane {t_pkg:.3f} s; {card}")
    run_dir = os.path.join(work, "fleet_obs")
    t = time.perf_counter()
    fproc, finfo = serve_proc([root, "--workers", "2", "--port", "0",
                               "--run-dir", run_dir, "--cache-mb", "512",
                               "--request-timeout", "60",
                               "--fleet-backoff", "0.1", "--device",
                               SERVE_DEVICE])
    try:
        check(finfo["ready"] is True, f"(16e) fleet {finfo}")
        ready = await_events(run_dir, "worker_ready", 2)
        say(f"(16e) fleet up in {time.perf_counter() - t:.2f} s; worker "
            f"start-up (interpreter, torch, CUDA context, artifact, bind): "
            + ", ".join(f"w{e['worker']} {e['startup_s']} s" for e in ready)
            + f"; {card}")
        box = {}
        loader = threading.Thread(target=lambda: box.update(run_load(
            finfo["serving"], threads=16, requests_per_thread=150, seed=19,
            p=a1.p_original, retries=20, timeout=60.0)))
        loader.start()
        time.sleep(1.0)
        os.kill(ready[0]["pid"], signal.SIGKILL)
        relaunch = await_events(run_dir, "worker_ready", 3)[2]
        loader.join(timeout=600)
        check(not loader.is_alive() and box, "(16e) the load hung")
        load_report(box, card, "fleet, one worker SIGKILLed")
        deaths = fleet_events(run_dir, "worker_death")
        check(len(deaths) == 1 and not deaths[0]["instant"],
              f"(16e) deaths {deaths}")
        say(f"(16e) worker {relaunch['worker']} SIGKILLed after "
            f"{deaths[0]['uptime_s']} s, respawned (launch "
            f"{relaunch['launch']}) serving again after "
            f"{relaunch['startup_s']} s; no request dropped; {card}")
        last = stop_proc(fproc, "fleet")
        check(fleet_events(run_dir, "fleet_drained")[0]["exits"] == [0, 0],
              "(16e) a worker did not drain cleanly")
        say(f"(16e) SIGTERM drained the fleet: {last}")
    finally:
        if fproc.poll() is None:
            fproc.kill()
            fproc.communicate()
    # (f) no Gibbs kernel on the serving path (this process's engines and
    # server; the served processes run the same code)
    launched = cuda_lib.launch_counts()
    check(not any(launched.values()), f"(16f) kernels launched: {launched}")
    say(f"(16f) kernel launches across the serving steps: "
        f"{json.dumps(launched)}")
    say(f"(16) done in {time.perf_counter() - t_phase:.1f} s; {card}")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--fit-child"]:
        fit_child(sys.argv[2])
        return
    try:
        import torch
    except ImportError as e:
        fail(f"torch not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    try:
        import dcfm_tpu_torch as dt
        from dcfm_tpu_torch import native
        from dcfm_tpu_torch.ops import batched_solve as bs
        from dcfm_tpu_torch.ops import chol_sample as k1
        from dcfm_tpu_torch.ops import cuda_lib
        from dcfm_tpu_torch.ops import lam_update as k2
        from dcfm_tpu_torch.ops import sse_gamma as k5
    except ImportError as e:
        fail(f"the dcfm_tpu_torch package is not beside this script: {e}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the port needs full float32")

    t_start = time.perf_counter()
    card = card_line()
    say(card)          # name, power limit (nvidia-smi's line)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    native.build()
    check(native.available(), "the native assembler did not load")
    say(f"native assembler built with g++ in {time.perf_counter() - t:.1f} "
        "s")
    t = time.perf_counter()
    lib_path, log = cuda_lib.build()
    say(f"kernels built in {time.perf_counter() - t:.1f} s")
    kernel_report(log)
    sass_report(cuda_lib, lib_path)

    rng = np.random.default_rng(0)
    kernels = [k1_phase(torch, k1, cuda_lib, rng, card),
               k4_phase(torch, bs, rng),
               k3_phase(torch, bs, rng), k2_phase(torch, k2)]
    k5_rec, floor_ms = k5_phase(torch, k5, cuda_lib, card)
    kernels.append(k5_rec)
    if "--kernels-only" in sys.argv[1:]:
        for k in kernels:
            say(json.dumps(k))
        say("kernel phase only: no fits were run and no result is printed")
        return

    c = FIT
    Y, L, noise = synthetic(c["n"], c["p"], c["k_true"])
    if "--scenarios-only" in sys.argv[1:]:
        import shutil
        import tempfile
        work = tempfile.mkdtemp(prefix="dcfm_scen_")
        try:
            scenario_phase(torch, dt, cuda_lib, k1, k5, card, Y, L, noise,
                           work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say("scenario phase only: no result is printed")
        return
    if "--knobs-only" in sys.argv[1:]:
        import shutil
        import tempfile
        work = tempfile.mkdtemp(prefix="dcfm_knobs_")
        try:
            knobs_phase(torch, dt, cuda_lib, card, Y, L, noise,
                        {"f32": None}, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say("knob phase only: no result is printed")
        return
    if "--outer-only" in sys.argv[1:]:
        import shutil
        import tempfile
        work = tempfile.mkdtemp(prefix="dcfm_outer_")
        try:
            outer_phase(torch, dt, cuda_lib, card, Y, L, noise, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say("outer phase only: no result is printed")
        return
    if "--serve-only" in sys.argv[1:]:
        import shutil
        import tempfile
        work = tempfile.mkdtemp(prefix="dcfm_serve_")
        try:
            serve_phase(torch, dt, cuda_lib, card, Y, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say("serve phase only: no result is printed")
        return
    if "--ingest-only" in sys.argv[1:]:
        import shutil
        import tempfile
        work = tempfile.mkdtemp(prefix="dcfm_ingest_")
        try:
            scale_phase(torch, dt, cuda_lib, card, Y, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        say("ingest phase only: no result is printed")
        return
    for label, model, backend, _ in FIT_PATHS:
        graph_equality_phase(torch, cuda_lib, path_config(dt, model, backend),
                             Y, card, label, 8)
    graph_equality_phase(torch, cuda_lib, path_config(
        dt, {"lambda_kernel": "pallas"}, {"sse_mode": "resid"}), Y, card,
        "f32 resid", 8)
    graph_equality_phase(torch, cuda_lib, path_config(
        dt, *FIT_PATHS[0][1:3]), Y, card, "f32", dt.api.CUDA_AUTO_UNROLL)
    unroll_phase(torch, path_config(dt, *FIT_PATHS[0][1:3]), Y, card)
    say(f"unroll_phase done at {time.perf_counter() - t_start:.1f} s")
    say(f"graph and kernel phases done at "
        f"{time.perf_counter() - t_start:.1f} s")
    launches, errs, digests = {}, {}, {}
    for label, model, backend, path_kernels in FIT_PATHS:
        got, cfg, errs[label], res = fit_phase(
            torch, dt, cuda_lib, card, label, model, backend, path_kernels,
            Y, L, noise)
        digests[label] = sigma_digest(res.Sigma)
        say(f"fit [{label}] sigma sha256 {digests[label]}")
        del res
        for name in path_kernels:          # a kernel's count from its path
            launches.setdefault(name, got[name])
        sweep_profile(torch, cfg, Y, card, label)
    say(f"|err_bf16 - err_f32| = {abs(errs['bf16'] - errs['f32']):.3e}, "
        f"|err_fused - err_f32| = {abs(errs['fused'] - errs['f32']):.3e}")
    upload_phase(torch, dt, cuda_lib, card, Y, L, noise)
    say(f"upload_phase done at {time.perf_counter() - t_start:.1f} s")
    digests["f32 quant8"] = fetch_phase(torch, dt, cuda_lib, card, Y, L,
                                        noise)
    say(f"fetch_phase done at {time.perf_counter() - t_start:.1f} s")
    checkpoint_phase(torch, dt, cuda_lib, card, Y, L, noise)
    say(f"checkpoint_phase done at {time.perf_counter() - t_start:.1f} s")
    sd_phase(torch, dt, cuda_lib, card, Y, L, noise, digests["f32"])
    say(f"sd_phase done at {time.perf_counter() - t_start:.1f} s")
    import shutil
    import tempfile
    work = tempfile.mkdtemp(prefix="dcfm_export_")
    try:
        export_phase(torch, dt, cuda_lib, card, Y, work)
        say(f"export_phase done at {time.perf_counter() - t_start:.1f} s")
        stream_artifact_phase(torch, dt, cuda_lib, card, Y, work)
        say(f"stream_artifact_phase done at "
            f"{time.perf_counter() - t_start:.1f} s")
        elastic_phase(dt, card, work)
        say(f"elastic_phase done at {time.perf_counter() - t_start:.1f} s")
        scen, c5 = scenario_phase(torch, dt, cuda_lib, k1, k5, card, Y, L,
                                  noise, work)
        say(f"scenario_phase done at {time.perf_counter() - t_start:.1f} s")
        knobs_phase(torch, dt, cuda_lib, card, Y, L, noise, digests, work)
        say(f"knobs_phase done at {time.perf_counter() - t_start:.1f} s")
        scale = scale_phase(torch, dt, cuda_lib, card, Y, work, c5)
        say(f"scale_phase done at {time.perf_counter() - t_start:.1f} s")
        outer = outer_phase(torch, dt, cuda_lib, card, Y, L, noise, work)
        say(f"outer_phase done at {time.perf_counter() - t_start:.1f} s")
        serve_phase(torch, dt, cuda_lib, card, Y, work)
        say(f"serve_phase done at {time.perf_counter() - t_start:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches["cho_solve"] = k3_path(torch, bs, cuda_lib, rng)["cho_solve"]
    for k in kernels:
        k["launches"] = launches[k["name"]]
        say(f"{k['name']}: kernel {k['ms'] * 1e3:.2f} us on the device "
            f"({k['call_ms'] * 1e3:.2f} us per wrapper call), plain "
            f"{k['plain_ms'] * 1e3:.2f} us, library "
            f"{k['library_ms'] * 1e3:.2f} us, bound "
            f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}): "
            f"{(k['ms'] - k['bound_ms']) * 1e3:.2f} us above the bound, "
            f"{(k['ms'] - floor_ms) * 1e3:.2f} us above the K5-sized pass; "
            f"{k['launches']} launches on its path; {card}")
    for path, got in scen.items():
        say(f"scenario launches [{path}]: " + json.dumps(
            {k: v for k, v in got.items() if v}))
    for path, got in scale.items():
        say(f"scale launches [{path}]: " + json.dumps(
            {k: v for k, v in got.items() if v}))
    for path, got in outer.items():
        say(f"outer launches [{path}]: " + json.dumps(
            {k: v for k, v in got.items() if v}))
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
