#!/usr/bin/env python3
"""Sigma digests of the PyTorch port's north-star fits, for comparing two
trees of the port on one card.

    python3 scripts/torch_sigma_hashes.py --root PATH [--reps N]

Imports ``dcfm_tpu_torch`` from the tree at PATH (a checkout of any
version of the port) and fits, on the card, chip_smoke.py's north-star
configuration (p = 10,000, g = 64 shards, n = 500, K = 8, 2 chains, 200
burn-in + 200 kept at thin 2, sse_mode="auto", no checkpoint) along the
float32, bf16 and fused paths and the float32 path under
fetch_dtype="quant8", each after a 4-sweep warm-up of the same path.  Per
fit one JSON line: the sha256 of Sigma's float32 bytes, chain
iterations/s (all chains' sweeps / chain_s), the phase seconds, the
kernel launches and the peak allocated device memory, with the card's
name and power limit.  Two
trees whose lines carry the same digests computed the same Sigma bit for
bit.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

FIT = dict(p=10_000, n=500, k_true=8, g=64, K=8, rho=0.9, chains=2,
           burnin=200, mcmc=200, thin=2)
PATHS = (("f32", {"lambda_kernel": "pallas"}, {}),
         ("bf16", {"lambda_kernel": "auto"}, {"compute_dtype": "bf16"}),
         ("fused", {"lambda_kernel": "pallas-fused"}, {}),
         ("f32 quant8", {"lambda_kernel": "pallas"},
          {"fetch_dtype": "quant8"}))


def synthetic(n: int, p: int, k_true: int, noise: float = 0.2, seed=0):
    """chip_smoke.py's data: Y = F L' + noise * eps."""
    r = np.random.default_rng(seed)
    L = r.normal(size=(p, k_true)) / np.sqrt(k_true)
    F = r.normal(size=(n, k_true))
    Y = F @ L.T + noise * r.normal(size=(n, p))
    return Y.astype(np.float32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True,
                    help="the tree whose dcfm_tpu_torch is fitted")
    ap.add_argument("--reps", type=int, default=1,
                    help="fits of each path")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this script needs a "
                 "CUDA device")
    import dcfm_tpu_torch as dt
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    c = FIT
    Y = synthetic(c["n"], c["p"], c["k_true"])
    for label, model, backend in PATHS:
        cfg = dt.FitConfig(
            model=dt.ModelConfig(num_shards=c["g"], factors_per_shard=c["K"],
                                 rho=c["rho"], **model),
            run=dt.RunConfig(burnin=c["burnin"], mcmc=c["mcmc"],
                             thin=c["thin"], seed=0, num_chains=c["chains"]),
            backend=dt.BackendConfig(sse_mode="auto", **backend))
        dt.fit(Y, dataclasses.replace(cfg, run=dt.RunConfig(burnin=2,
                                                            mcmc=2)))
        for rep in range(args.reps):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = dt.fit(Y, cfg)
            wall = time.perf_counter() - t
            sweeps = c["chains"] * (c["burnin"] + c["mcmc"])
            print(json.dumps({
                "root": args.root, "path": label, "rep": rep,
                "sigma_sha256": hashlib.sha256(np.ascontiguousarray(
                    res.Sigma, np.float32).view(np.uint8)).hexdigest(),
                "chain_iters_per_s": sweeps / res.phase_seconds["chain_s"],
                "wall_s": wall, "phase_seconds": res.phase_seconds,
                "kernel_launches": res.kernel_launches,
                "peak_allocated": torch.cuda.max_memory_allocated(),
                "card": card}), flush=True)
            del res


if __name__ == "__main__":
    main()
