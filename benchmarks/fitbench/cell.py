"""One run of one cell: set-up, the measured window of whole fits, the
comparison that decides ``correct``, and the metrics.

Set-up (``setup_s``, from the process's start): import the program, make
the cell's data from the seed on the device, and run one short warm fit
at the cell's shapes (the cuBLAS and cuSOLVER handles, the allocator, the
kernels' build or load, the native assembler).  The window: whole
``dcfm_tpu_torch.api.fit`` calls back to back on the same data, fit i on
run seed ``data.run_seed(seed, i)``, each with the cell's full schedule,
started until ``seconds`` have passed; the fit in flight then finishes
and counts.  With ``trace`` one more fit runs under the profiler before
the window (fit 0), and the program's clocks are read from the window's
fits, which the profiler does not see.

Once the window has closed and the peak memory is read, one fit drawn
from the seed among those that completed is held against the plain
reference (fitbench/check.py).
"""

from __future__ import annotations

import dataclasses
import gc
import sys
import time

import numpy as np
import torch

from fitbench import check, data, peaks, spec, trace as tracing

JAX_NAMES = ("jax", "jaxlib", "flax", "dcfm_tpu")


class JaxLoaded(RuntimeError):
    """JAX or the JAX package was loaded in the measuring process."""


def jax_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(JAX_NAMES))


def shape_of(config: dict) -> dict:
    """The sweep's shapes: G shards of n rows and P columns, K factors."""
    d, m = config["data"], config["model"]
    g = int(m["num_shards"])
    return {"G": g, "n": int(d["n"]), "P": -(-int(d["p"]) // g),
            "K": int(m["factors_per_shard"])}


def fit_config(config: dict, schedule: dict, seed: int):
    """The program's FitConfig for ``config`` under ``schedule``: every
    field the configuration file names, by name; a ``ModelConfig`` field
    whose default is a dataclass (a prior's or the adaptation's
    sub-config) is built as that dataclass from the file's group."""
    import dcfm_tpu_torch as dt

    model = dict(config["model"])
    for f in dataclasses.fields(dt.ModelConfig):
        if f.name in model and dataclasses.is_dataclass(f.default):
            model[f.name] = type(f.default)(**model[f.name])
    run = dict(config["run"], burnin=int(schedule["burnin"]),
               mcmc=int(schedule["mcmc"]), thin=int(schedule["thin"]),
               seed=int(seed))
    return dt.FitConfig(model=dt.ModelConfig(**model),
                        run=dt.RunConfig(**run),
                        backend=dt.BackendConfig(**config["backend"]),
                        **config["fit"])


def warm_schedule(traffic: dict) -> dict:
    """A short schedule that meets both trip patterns (saving and not)
    often enough to capture and replay each, and ends in the fetch."""
    thin = int(traffic["thin"])
    return {"burnin": thin, "mcmc": 3 * thin, "thin": thin}


@dataclasses.dataclass
class FitRecord:
    """What the metrics read of one fit."""
    seconds: float
    phase: dict
    graphs: dict
    launches: dict
    sweeps: int             # sweeps of one chain
    chains: int
    saved: int              # saved draws of one chain


def record(res, traffic: dict) -> FitRecord:
    return FitRecord(
        seconds=float(res.seconds), phase=dict(res.phase_seconds),
        graphs=dict(res.graphs), launches=dict(res.kernel_launches),
        sweeps=int(res.traces.shape[1]), chains=int(res.traces.shape[0]),
        saved=int(traffic["mcmc"]) // int(traffic["thin"]))


@dataclasses.dataclass
class Context:
    """What a per-layer metric reader (metrics/<name>.py) gets."""
    shape: dict
    fits: list              # FitRecords of the fits the profiler missed
    traced: object          # the profiled fit's FitRecord, or None
    trace: object           # its tracing.Trace, or None
    counts: object = spec.counts
    peaks: object = peaks


def answer_of(config: dict, res):
    """The part of a fit that is judged, kept once its fit is dropped:
    the dense Sigma, or the packed result's block reader."""
    if config["answer"] == "sigma":
        return res.Sigma
    return res.sigma_block


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, *, log=sys.stderr) -> dict:
    """The result line's object: correct, attempted, failed, metrics,
    device, breakdown (traced) and, last, compared."""
    import dcfm_tpu_torch
    from dcfm_tpu_torch import api

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic = cell.config, cell.traffic
    check.reference_module(config)
    Y = data.make_data(config["data"], seed, dev)
    warm = fit_config(config, warm_schedule(traffic),
                      data.run_seed(seed, 4095))
    dcfm_tpu_torch.fit(Y, warm, device=dev)
    del warm
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    pick = np.random.default_rng([int(seed), 0x5A11])
    kept = kept_seed = None
    fits, profiled, summary = [], None, None
    i = 0

    def keep(res, i):
        # one fit kept for the comparison, drawn uniformly from those
        # that complete (a reservoir of one, from the seed)
        nonlocal kept, kept_seed
        if pick.random() < 1.0 / (i + 1):
            kept, kept_seed = answer_of(config, res), res.config.run.seed

    if traced:
        # the profiled fit runs before the window, which then holds as
        # many unprofiled fits as an untraced run's
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        cfg = fit_config(config, traffic, data.run_seed(seed, i))
        with profile(activities=acts) as prof:
            with tracing.phase_spans(api), record_function(tracing.FIT_SPAN):
                res = dcfm_tpu_torch.fit(Y, cfg, device=dev)
        profiled = record(res, traffic)
        if cuda:
            summary = tracing.summarize(prof.profiler.kineto_results.events())
            kinds = {}
            for ops, _ in summary.replays:
                kinds[ops] = kinds.get(ops, 0) + 1
            print(f"traced fit: {summary.window_s:.3f} s, graph replays by "
                  f"device operations {kinds}", file=log)
        del prof
        keep(res, i)
        del res
        i += 1
    start = time.perf_counter()
    while True:
        cfg = fit_config(config, traffic, data.run_seed(seed, i))
        res = dcfm_tpu_torch.fit(Y, cfg, device=dev)
        fits.append(record(res, traffic))
        keep(res, i)
        del res
        i += 1
        if time.perf_counter() - start >= seconds:
            break
    window_s = time.perf_counter() - start
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    for name, key in (("fit", None), ("chain", "chain_s"),
                      ("preprocess", "preprocess_s"),
                      ("assemble", "assemble_s")):
        print(f"window {name} seconds: " + " ".join(
            f"{f.seconds if key is None else f.phase[key]:.4f}"
            for f in fits), file=log)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, after the window and the peak, on freed memory
    t = time.perf_counter()
    got = check.judge(config, traffic, Y, kept_seed, kept, dev)
    correct, rows = check.verdict(config, got)
    print(f"reference of run seed {kept_seed}: "
          f"{time.perf_counter() - t:.1f} s", file=log)
    found = jax_modules()
    if found:
        raise JaxLoaded("loaded after the window: " + ", ".join(found))

    out = {"correct": bool(correct), "attempted": i,
           "failed": 0 if correct else 1}
    if traced:
        ctx = Context(shape=shape_of(config), fits=fits, traced=profiled,
                      trace=summary)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    else:
        e2e = {"fit_s": window_s / len(fits), "setup_s": setup_s,
               "peak_mem_GiB": peak / 2.0 ** 30}
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if cuda else dev.type,
        "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
        "count": cell.chips, "memory_peak_bytes": peak}
    if summary is not None:
        out["device"].update(busy_s=summary.busy_s,
                             window_s=summary.window_s)
        out["breakdown"] = summary.breakdown()
    # the numbers compared, each beside its limit: the line's last key
    out["compared"] = {name: {"value": v, "limit": lim}
                       for name, v, lim in rows}
    return out
