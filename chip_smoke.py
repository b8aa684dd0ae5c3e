#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card (name and power limit, as nvidia-smi reports them),
   builds the hand-written kernels from dcfm_tpu_torch/csrc with nvcc for
   sm_90a and prints the ptxas register/spill report.
2. Kernel phase: each kernel against its plain PyTorch version on the card,
   on identical inputs at the shapes the full-width fit gives it, with the
   tolerance stated; then the device time (torch.profiler) of the kernel,
   the plain version and one library yardstick, beside the least time the
   card could take, and the kernel's per-call time (CUDA events).
3. Fit phase: ``dcfm_tpu_torch.fit`` at the repo's north-star width
   (p = 10,000, g = 64 shards, n = 500, K = 8 factors per shard, 2 chains,
   sse_mode="auto", lambda_kernel="pallas") on synthetic factor data.  The
   launch counters are zeroed just before the fit and read just after: each
   kernel must have launched once per sweep.  Sigma must be finite and
   symmetric, the chains healthy, and its relative Frobenius error against
   the truth < 0.25 and at most twice the sample covariance's.
4. Where the time goes: 20 more sweeps of one chain at the same width and
   the fit's save mix (one draw in four accumulated), timed on the host
   clock and under torch.profiler: ms per sweep, the device's busy and
   idle share, and the kernels that take the most device time.

Any failed check exits non-zero before the last line.  The line before the
last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
dcfm_tpu_torch package beside this file, the script exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import math
import os
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


def chol_sample_flops(K: int) -> int:
    """Arithmetic of one K x K factor-solve-sample, as the kernel does it
    (each multiply, add, divide and square root counted once)."""
    chol = sum(2 * (K - j) * j + 1 + (K - 1 - j) for j in range(K))
    fwd = sum(2 * j + 1 for j in range(K))
    bwd = sum(4 * (K - 1 - j) + 3 for j in range(K))
    return chol + fwd + bwd + K


def spd(A: np.ndarray) -> np.ndarray:
    """(B, K, K) SPD precisions A A' + 2I from (B, K, K) draws A."""
    K = A.shape[-1]
    return A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(K, dtype=np.float32)


def k1_phase(torch, k1, rng) -> dict:
    """K1 against its plain version at the full-width shape and at
    K = 1, 4, 16 on a ragged batch; times at the full-width shape."""
    dev = torch.device("cuda")
    # tolerance: the kernel multiplies by 1/L_jj in the backward solves
    # where the plain version divides, and nvcc contracts mul+sub into FMA;
    # Q = A A' + 2I keeps the condition number below ~4K, so float32
    # rounding stays far inside 2e-4 abs + 2e-4 rel (the bound the JAX
    # package holds its Pallas kernel to against the unrolled version)
    rtol = atol = 2e-4
    worst = 0.0
    for B, K in ((FULL_B, FULL_K), (FULL_B + 1, 1), (FULL_B + 1, 4),
                 (FULL_B + 1, 16)):
        Q = torch.as_tensor(spd(rng.standard_normal((B, K, K), np.float32)),
                            device=dev)
        b = torch.as_tensor(rng.standard_normal((B, K), np.float32),
                            device=dev)
        z = torch.as_tensor(rng.standard_normal((B, K), np.float32),
                            device=dev)
        out = k1.chol_sample(Q, b, z)
        ref = k1.chol_sample_plain(Q, b, z)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        ok = bool(torch.all((out - ref).abs() <= atol + rtol * ref.abs()))
        say(f"K1 chol_sample B={B} K={K}: max_abs_err={err:.3e} "
            f"(tolerance {atol:g} + {rtol:g}*|plain|) "
            f"{'ok' if ok else 'MISMATCH'}")
        check(ok and math.isfinite(err), f"K1 disagrees at B={B} K={K}")
        if (B, K) == (FULL_B, FULL_K):
            worst = err
            Qf, bf, zf = Q, b, z
    B, K = FULL_B, FULL_K

    def library():
        L = torch.linalg.cholesky(Qf)
        v = torch.linalg.solve_triangular(L, bf[..., None], upper=False)
        mz = torch.linalg.solve_triangular(
            L.mT, torch.cat([v, zf[..., None]], dim=-1), upper=True)
        return mz.sum(dim=-1)

    check(float((library() - k1.chol_sample_plain(Qf, bf, zf)).abs().max())
          < 1e-3, "K1 library yardstick computes another function")
    ms = device_ms(lambda: k1.chol_sample(Qf, bf, zf), 200)
    call = cuda_ms(lambda: k1.chol_sample(Qf, bf, zf), 200)
    plain = device_ms(lambda: k1.chol_sample_plain(Qf, bf, zf), 20)
    lib = device_ms(library, 50)
    bnd, by = bound_ms(4.0 * B * (K * K + 3 * K), B * chol_sample_flops(K))
    return dict(name="chol_sample", route="cuda",
                source="dcfm_tpu_torch/csrc/chol_sample.cu",
                replaces="dcfm_tpu/ops/pallas_gaussian.py:44",
                max_abs_err=worst, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib)


def k5_phase(torch, k5, rng) -> dict:
    """K5 against its plain version at the full-width shape, with rows
    whose SSE cancels to (or below) zero so the clamp is exercised."""
    dev = torch.device("cuda")
    B, K, bs = FULL_B, FULL_K, 0.3
    Lam = rng.standard_normal((B, K)).astype(np.float32)
    M = rng.standard_normal((B, K)).astype(np.float32)
    EYt = rng.standard_normal((B, K)).astype(np.float32) * 5
    quad = np.sum(Lam.astype(np.float64) * M, axis=1)
    dot2 = np.sum(Lam.astype(np.float64) * EYt, axis=1)
    sse_true = rng.uniform(0.0, 500.0, B)
    sse_true[:64] = 0.0                 # near-perfect fit: cancels to ~0
    sse_true[64:128] = -1e-3            # overshoot: must clamp to exactly 0
    yty = (sse_true + 2 * dot2 - quad).astype(np.float32)
    g = rng.gamma(250.5, 1.0, B).astype(np.float32)
    t = [torch.as_tensor(a, device=dev) for a in (Lam, M, EYt, yty, g)]
    ps, sse = k5.sse_ps(*t, bs=bs)
    ps_p, sse_p = k5.sse_ps_plain(*t, bs)
    torch.cuda.synchronize()
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
              and torch.all(sse[64:128] == 0) and torch.all(sse >= 0))
    err = max(float((sse - sse_p).abs().max()), float((ps - ps_p).abs().max()))
    say(f"K5 sse_ps B={B} K={K}: max_abs_err={err:.3e} (tolerance "
        f"4*K*eps*|terms| on sse, propagated to ps; clamp rows exact) "
        f"{'ok' if ok else 'MISMATCH'}")
    check(ok and math.isfinite(err), "K5 disagrees with its plain version")

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
    return dict(name="sse_ps", route="cuda",
                source="dcfm_tpu_torch/csrc/sse_ps.cu",
                replaces="dcfm_tpu/ops/sse_gamma.py:127",
                max_abs_err=err, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bnd, bound_by=by, library_ms=lib)


def synthetic(n: int, p: int, k_true: int, noise: float = 0.2,
              seed: int = 0):
    """Y = F L' + noise * eps with known Sigma = L L' + noise^2 I."""
    r = np.random.default_rng(seed)
    L = r.normal(size=(p, k_true)) / np.sqrt(k_true)
    F = r.normal(size=(n, k_true))
    Y = F @ L.T + noise * r.normal(size=(n, p))
    return Y.astype(np.float32), L.astype(np.float32), noise


def fit_phase(torch, dt, cuda_lib, card: str) -> dict:
    c = FIT
    Y, L, noise = synthetic(c["n"], c["p"], c["k_true"])
    cfg = dt.FitConfig(
        model=dt.ModelConfig(num_shards=c["g"], factors_per_shard=c["K"],
                             rho=c["rho"], lambda_kernel="pallas"),
        run=dt.RunConfig(burnin=c["burnin"], mcmc=c["mcmc"], thin=c["thin"],
                         seed=0, num_chains=c["chains"]),
        backend=dt.BackendConfig(sse_mode="auto"))
    torch.cuda.reset_peak_memory_stats()
    cuda_lib.reset_launch_counts()
    t0 = time.perf_counter()
    res = dt.fit(Y, cfg)                                  # device="cuda"
    wall = time.perf_counter() - t0
    launches = cuda_lib.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
    say(f"fit: {sweeps} sweeps in {res.phase_seconds['chain_s']:.3f} s "
        f"chain time = {res.iters_per_sec:.2f} iters/s "
        f"(wall {wall:.3f} s; {card})")
    say("fit phase_seconds: " + json.dumps(res.phase_seconds))
    say(f"fit peak device memory: {peak} bytes "
        f"({peak / 2**30:.3f} GiB; {card})")
    say(f"fit kernel launches: {json.dumps(launches)} "
        f"(expected {sweeps} each)")
    for name in ("chol_sample", "sse_ps"):
        check(launches[name] == sweeps,
              f"{name} launched {launches[name]} times in {sweeps} sweeps")
    S = res.Sigma
    check(S.shape == (c["p"], c["p"]), f"Sigma shape {S.shape}")
    check(bool(np.isfinite(S).all()), "Sigma has non-finite entries")
    dev = torch.device("cuda")
    Sd = torch.as_tensor(S, device=dev)
    asym = float((Sd - Sd.T).abs().max() / Sd.abs().max())
    check(asym <= 1e-6, f"Sigma asymmetric (max rel {asym:.2e})")
    check(res.stats.nonfinite_count == 0 and res.stats.acc_nonfinite == 0,
          f"chain health: {res.stats}")
    Lt = torch.as_tensor(L, device=dev)
    St = Lt @ Lt.T + noise ** 2 * torch.eye(c["p"], device=dev)
    err = float(torch.linalg.norm(Sd - St) / torch.linalg.norm(St))
    Yc = torch.as_tensor(Y, device=dev)
    Yc = Yc - Yc.mean(dim=0)
    Ss = Yc.T @ Yc / (c["n"] - 1)
    err_sample = float(torch.linalg.norm(Ss - St) / torch.linalg.norm(St))
    say(f"fit rel Frobenius error vs truth: {err:.4f} "
        f"(sample covariance: {err_sample:.4f})")
    check(err < 0.25, f"rel Frobenius error {err:.4f} >= 0.25")
    check(err <= 2 * err_sample,
          f"rel Frobenius error {err:.4f} > 2x the sample covariance's")
    return launches, cfg, Y


def sweep_profile(torch, cfg, Y, card: str) -> None:
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from dcfm_tpu_torch.models.priors import make_prior
    from dcfm_tpu_torch.models.sampler import init_chain, run_chunk
    from dcfm_tpu_torch.noise import TorchNoise
    from dcfm_tpu_torch.utils.preprocess import preprocess
    m = dataclasses.replace(cfg.model, sse_mode=cfg.backend.sse_mode)
    Yd = torch.as_tensor(preprocess(Y, m.num_shards, seed=0).data,
                         device="cuda")
    noise, prior = TorchNoise(0, "cuda"), make_prior(m)
    carry = init_chain(noise.init(0), Yd, m, prior)
    n = 20

    def window(carry):
        # thin 4 from the window's start: one sweep in four accumulates,
        # the fit's mix (200 burn-in + 200 kept at thin 2)
        return run_chunk(noise, 0, Yd, carry, m, prior, num_iters=n,
                         burnin=carry.iteration, thin=4)[0]

    carry = window(carry)                                 # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    carry = window(carry)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t) * 1e3 / n
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        carry = window(carry)
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t) * 1e3 / n
    busy, rows = device_busy_ms(prof)
    busy /= n
    say(f"sweep: {wall:.3f} ms per sweep on the host clock "
        f"({wall_prof:.3f} ms under the profiler); device busy "
        f"{busy:.3f} ms per sweep = {busy / wall_prof:.1%} of the "
        f"profiled wall, idle {1 - busy / wall_prof:.1%}; {card}")
    for name, ms in rows[:12]:
        say(f"  {ms / n * 1e3:9.2f} us/sweep  {name[:100]}")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import torch
    except ImportError as e:
        fail(f"torch not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA device")
    try:
        import dcfm_tpu_torch as dt
        from dcfm_tpu_torch.ops import chol_sample as k1
        from dcfm_tpu_torch.ops import cuda_lib
        from dcfm_tpu_torch.ops import sse_gamma as k5
    except ImportError as e:
        fail(f"the dcfm_tpu_torch package is not beside this script: {e}")
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 matmuls are on; the port needs full float32")

    card = card_line()
    say(card)          # name, power limit (nvidia-smi's line)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    _, log = cuda_lib.build()
    say(f"kernels built in {time.perf_counter() - t:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line:
            say(line.rstrip())

    rng = np.random.default_rng(0)
    kernels = [k1_phase(torch, k1, rng), k5_phase(torch, k5, rng)]
    launches, fit_cfg, Y = fit_phase(torch, dt, cuda_lib, card)
    sweep_profile(torch, fit_cfg, Y, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        say(f"{k['name']}: kernel {k['ms'] * 1e3:.2f} us on the device "
            f"({k['call_ms'] * 1e3:.2f} us per wrapper call), plain "
            f"{k['plain_ms'] * 1e3:.2f} us, library "
            f"{k['library_ms'] * 1e3:.2f} us, bound "
            f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}); {card}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": torch.cuda.get_device_name(0),
      "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
