"""One process of a gloo pod of the port, for tests/test_torch_pod*.py and
tests/test_torch_coop_export.py: it joins the pod from the DCFM_*
environment (parallel/multihost.initialize_from_env, on the CPU), fits
the data file of its spec with the spec's config, and writes its
results to ``<out>.proc<K>.npz``.  Run as

    DCFM_COORDINATOR=127.0.0.1:PORT DCFM_NUM_PROCESSES=N DCFM_PROCESS_ID=K \\
        python tests/torch_pod_rank.py SPEC.json

SPEC: {"data": Y.npy, "out": prefix, "model": {...}, "run": {...},
"backend": {...}, "fit": {FitConfig fields}}.  The helpers below start
such pods (:func:`run_pod`) on ports taken from the system
(:func:`free_port_base`), never fixed ones.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port_base(count: int = 1) -> int:
    """A port p - 1 such that p .. p + count - 1 are free now (the pod
    supervisor's attempt k listens on base + k)."""
    for _ in range(50):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        if p + count >= 65535:
            continue
        ok = True
        for q in range(p + 1, p + count):
            t = socket.socket()
            try:
                t.bind(("127.0.0.1", q))
            except OSError:
                ok = False
            finally:
                t.close()
        if ok:
            return p - 1
    raise RuntimeError("no run of free ports")


def pod_env(port: int, n: int, i: int, extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update({"DCFM_COORDINATOR": f"127.0.0.1:{port}",
                "DCFM_NUM_PROCESSES": str(n), "DCFM_PROCESS_ID": str(i),
                "DCFM_FAULT_PROCESS": str(i)})
    env.update(extra or {})
    return env


def run_pod(argv_of, n: int, workdir: str, *, env=None,
            timeout: float = 120.0) -> list:
    """Start ``n`` processes, process i running ``argv_of(i)``, meeting on a
    fresh port; wait for all (killing every one past ``timeout``).
    Returns ``[(exit code, stdout + stderr)]`` in process order."""
    port = free_port_base(1) + 1
    procs, logs = [], []
    for i in range(n):
        log = open(os.path.join(workdir, f"pod{port}.{i}.log"), "w+")
        logs.append(log)
        procs.append(subprocess.Popen(
            argv_of(i), cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            stdin=subprocess.DEVNULL, env=pod_env(port, n, i, env)))
    out = []
    try:
        for p in procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for p, log in zip(procs, logs):
            log.seek(0)
            out.append((p.returncode, log.read()))
            log.close()
    return out


def run_pod_fit(spec: dict, n: int, workdir: str, **kw) -> list:
    """:func:`run_pod` of this script on ``spec``."""
    path = os.path.join(workdir, f"spec{len(os.listdir(workdir))}.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    return run_pod(lambda i: [sys.executable, os.path.abspath(__file__),
                              path], n, workdir, **kw)


def write_set(src: str, dst: str, world: int) -> list:
    """Rewrite the plain checkpoint ``src`` as the ``world``-rank
    ``.procK-of-N`` set at ``dst``: each rank's block of every leaf, as a
    pod of ``world`` processes lays its ranks out
    (parallel/mesh.make_pod_layout), written by the port's per-rank writer
    with the file's bookkeeping.  Returns the set's paths."""
    from dcfm_tpu_torch.parallel.mesh import make_pod_layout
    from dcfm_tpu_torch.parallel.shard import local_leaves
    from dcfm_tpu_torch.utils import checkpoint as ck
    meta = ck.verify_checkpoint(src)
    cfg = ck.config_from_checkpoint_meta(meta)
    m, C = cfg.model, cfg.run.num_chains
    with np.load(src) as z:
        P, n = z["leaf_0"].shape[-2], z["leaf_1"].shape[-2]
    leaves, meta = ck.load_checkpoint(src, ck.carry_template(
        m, n=n, P=P, num_chains=C,
        num_stored_draws=cfg.run.num_saved if cfg.run.store_draws else 0))
    for r in range(world):
        lay = make_pod_layout(world, r, m.num_shards, C)
        ck.save_checkpoint_multiprocess(
            dst, local_leaves(lay, leaves), cfg, layout=lay,
            fingerprint=meta["fingerprint"],
            state_only=bool(meta.get("state_only")),
            acc_start=int(meta.get("acc_start", 0)),
            chain_acc_starts=meta.get("chain_acc_starts"),
            fold_draws=int(meta.get("fold_draws", 0)),
            elastic_lineage=int(meta.get("elastic_lineage", 0)),
            pod_adoptions=int(meta.get("pod_adoptions", 0)))
    return [ck.proc_path(dst, r, world) for r in range(world)]


def same_artifact_bytes(a: str, b: str) -> None:
    """Two artifact directories hold the same panel and meta.json bytes
    and equal maps arrays."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name == "maps.npz":
            with np.load(os.path.join(a, name)) as x, \
                    np.load(os.path.join(b, name)) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
            continue
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


def main(spec_path: str) -> None:
    import torch
    import dcfm_tpu_torch as dt
    from dcfm_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    with open(spec_path) as f:
        spec = json.load(f)
    pid = multihost.initialize_from_env(device="cpu")
    Y = np.load(spec["data"])
    cfg = dt.FitConfig(
        model=dt.ModelConfig(**spec.get("model", {})),
        run=dt.RunConfig(**spec.get("run", {})),
        backend=dt.BackendConfig(**spec.get("backend", {})),
        **spec.get("fit", {}))
    res = dt.fit(Y, cfg, device="cpu")
    out = {"Sigma": res.Sigma, "executed": res.traces.shape[1],
           "stats": np.asarray(list(res.stats), np.float64),
           "elastic": json.dumps(res.elastic_resume)}
    for k in ("_q8_panels", "_q8_scales", "_sd_q8_panels", "_sd_q8_scales",
              "_upper_f32"):
        v = getattr(res, k)
        if v is not None:
            out[k.lstrip("_")] = np.asarray(v)
    np.savez(f"{spec['out']}.proc{pid}.npz", **out)
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1])
