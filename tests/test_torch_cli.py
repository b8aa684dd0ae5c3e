"""The port's command line: ``python -m dcfm_tpu_torch.cli``.

The ``fit`` -> ``export`` -> ``serve`` -> ``promote`` -> ``delta`` round
trip on the CPU; the ``fit`` JSON has the JAX CLI's keys; the parsers of
the two CLIs accept the same flags (the port adds ``--device`` to
``serve`` and ``export``); what the port does not run is refused by
name; and ``strip_checkpoint`` of a port file resumes like a light
checkpoint.
"""

import argparse
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu.cli as jax_cli  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
import dcfm_tpu_torch.cli as port_cli  # noqa: E402
from dcfm_tpu_torch.serve.artifact import PosteriorArtifact  # noqa: E402
from dcfm_tpu_torch.utils.checkpoint import (  # noqa: E402
    read_checkpoint_meta, strip_checkpoint)
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_torch_fit import _names_a_queue_a_item  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, env=None, timeout=300):
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
        env=dict(os.environ, **(env or {})))
    return cp


def _json(cp):
    assert cp.returncode == 0, cp.stderr[-3000:]
    return json.loads(cp.stdout.strip().splitlines()[-1])


def _options(parser: argparse.ArgumentParser) -> dict:
    subs = next(a for a in parser._actions
                if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(s for a in p._actions for s in a.option_strings)
            for name, p in subs.choices.items()}


def test_parsers_accept_the_same_flags():
    jax_opts, port_opts = (_options(jax_cli.build_parser()),
                           _options(port_cli.build_parser()))
    assert set(port_opts) == set(jax_opts)
    for cmd in ("fit", "promote", "delta"):
        assert port_opts[cmd] == jax_opts[cmd], cmd
    for cmd in ("serve", "export"):
        assert port_opts[cmd] == sorted(jax_opts[cmd] + ["--device"]), cmd
    fit = {a.dest: a for a in port_cli.build_parser()._subparsers
           ._group_actions[0].choices["fit"]._actions}
    assert fit["backend"].choices == ["auto", "torch_cuda", "torch_cpu"]
    # the sixth subcommand, events, is the reader's own parser in both

    def events_flags(main):
        out = io.StringIO()
        with contextlib.redirect_stdout(out), pytest.raises(SystemExit):
            main(["events", "--help"])
        return sorted(set(re.findall(r"(?<![\w-])--[a-z][a-z-]*",
                                     out.getvalue())))

    assert events_flags(port_cli.main) == events_flags(jax_cli.main)


@pytest.mark.parametrize("argv,item", [
    (["supervise", "--", "fit", "Y.npy"], 7),
    (["watch", "data", "root"], 7),
    (["fit", "Y.npy", "-g", "2", "-k", "4", "--supervise"], 7),
    (["lint", "--list-rules"], None),
    (["test-isolated"], None),
])
def test_what_the_port_does_not_run_is_refused_by_name(argv, item):
    with pytest.raises(SystemExit) as e:
        port_cli.main(argv)
    msg = str(e.value.code)
    if item is None:
        assert f"python -m dcfm_tpu.cli {argv[0]}" in msg
        assert "ROADMAP" not in msg
    else:
        assert _names_a_queue_a_item(msg) and f"item {item}" in msg, msg


def test_mesh_and_multiprocess_fits_are_refused_citing_item_4(tmp_path,
                                                              monkeypatch):
    Y, _ = make_synthetic(24, 8, 2, seed=0)
    np.save(tmp_path / "Y.npy", Y)
    base = ["fit", str(tmp_path / "Y.npy"), "-g", "2", "-k", "4",
            "--burnin", "2", "--mcmc", "2", "--backend", "torch_cpu",
            "--out", str(tmp_path / "S.npy")]
    with pytest.raises(NotImplementedError) as e:
        port_cli.main(base + ["--mesh-devices", "2"])
    assert _names_a_queue_a_item(str(e.value)) and "item 4" in str(e.value)
    monkeypatch.setenv("DCFM_COORDINATOR", "localhost:1234")
    with pytest.raises(SystemExit) as e:
        port_cli.main(base)
    assert _names_a_queue_a_item(str(e.value.code))
    assert "item 4" in str(e.value.code)


def test_fit_json_has_the_jax_clis_keys(tmp_path):
    Y, _ = make_synthetic(24, 8, 2, seed=0)
    np.save(tmp_path / "Y.npy", Y)
    args = ["fit", str(tmp_path / "Y.npy"), "-g", "2", "-k", "4",
            "--burnin", "4", "--mcmc", "4", "--chains", "2",
            "--posterior-sd"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert jax_cli.main(args + ["--out", str(tmp_path / "J.npy")]) == 0
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    got = _json(_cli(*args, "--out", str(tmp_path / "T.npy"),
                     "--backend", "torch_cpu"))
    assert set(got) == set(want)
    assert set(got["phase_seconds"]) >= {"chain_s", "fetch_s"}
    assert got["shape"] == want["shape"] == [8, 8]
    assert set(got["rhat"]) == set(want["rhat"])
    S = np.load(tmp_path / "T.npy")
    assert S.shape == (8, 8) and np.isfinite(S).all()
    assert os.path.exists(got["sd_out"])


def _wait_generation(base, gen, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with urllib.request.urlopen(base + "/v1/entry?i=0&j=1",
                                    timeout=15) as r:
            body = json.loads(r.read())
            if int(r.headers["X-DCFM-Artifact-Generation"]) == gen:
                return body
        time.sleep(0.05)
    raise AssertionError(f"generation {gen} never served")


def test_fit_export_serve_promote_delta_round_trip(tmp_path):
    Y, _ = make_synthetic(30, 12, 2, seed=3)
    data = str(tmp_path / "Y.npy")
    np.save(data, Y)
    root = str(tmp_path / "root")
    os.makedirs(root)
    ck = str(tmp_path / "ck.npz")
    fit = _json(_cli("fit", data, "-g", "2", "-k", "4", "--burnin", "8",
                     "--mcmc", "8", "--posterior-sd", "--fetch-dtype",
                     "quant8", "--backend", "torch_cpu", "--checkpoint", ck,
                     "--out", str(tmp_path / "S.npy")))
    assert fit["out"] and os.path.exists(ck)
    e1 = _json(_cli("export", data, "--from-checkpoint", ck, "-o",
                    os.path.join(root, "v1"), "--device", "cpu"))
    assert e1["source"] == "checkpoint" and e1["has_sd"]
    stage = str(tmp_path / "stage" / "v2")
    e2 = _json(_cli("export", data, "-g", "2", "-k", "4", "--burnin", "8",
                    "--mcmc", "8", "--seed", "5", "--posterior-sd", "-o", stage,
                    "--device", "cpu"))
    assert e2["source"] == "fit" and e2["p"] == 12
    assert _json(_cli("promote", root, "v1"))["generation"] == 1
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve", root,
         "--port", "0", "--device", "cpu", "--swap-poll", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["device"] == "cpu" and info["generation"] == 1
        ref1 = PosteriorArtifact.open(os.path.join(root, "v1")).assemble()
        body = _wait_generation(info["serving"], 1)
        assert np.float32(body["value"]) == ref1[0, 1]
        d = _json(_cli("delta", stage, "--base", root, "--out",
                       os.path.join(root, "v2.delta")))
        assert d["bytes_shipped"] <= d["full_bytes"]
        applied = _json(_cli("delta", os.path.join(root, "v2.delta"),
                             "--apply", "--base", os.path.join(root, "v1"),
                             "--out", str(tmp_path / "applied")))
        assert applied["fingerprint"] == d["candidate_fingerprint"]
        p = _json(_cli("promote", root, "v2.delta", "--delta"))
        assert p["generation"] == 2 and p["delta"] is True
        ref2 = PosteriorArtifact.open(stage).assemble()
        body = _wait_generation(info["serving"], 2)
        assert np.float32(body["value"]) == ref2[0, 1]
        for name in ("mean_q8.bin", "maps.npz", "meta.json"):
            assert open(os.path.join(root, "v2", name), "rb").read() == \
                open(os.path.join(stage, name), "rb").read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1])["drained"] is True


def test_strip_checkpoint_resumes_like_a_light_checkpoint(tmp_path):
    """A full port file stripped to a light one, and the light file the
    same chain saved itself, resume into the same Sigma bit for bit."""
    Y, _ = make_synthetic(30, 8, 2, seed=4)

    def cfg(path, mcmc, **kw):
        return dt.FitConfig(
            model=dt.ModelConfig(num_shards=2, factors_per_shard=2,
                                 rho=0.5),
            run=dt.RunConfig(burnin=6, mcmc=mcmc, thin=2, chunk_size=4,
                             num_chains=2),
            checkpoint_path=path, **kw)

    full, light = str(tmp_path / "full.npz"), str(tmp_path / "light.npz")
    dt.fit(Y, cfg(full, 6), device="cpu")
    dt.fit(Y, cfg(light, 6, checkpoint_mode="light"), device="cpu")
    stripped = str(tmp_path / "stripped.npz")
    strip_checkpoint(full, stripped)
    meta = read_checkpoint_meta(stripped)
    assert meta["state_only"] and meta["acc_leaf_indices"] == []
    assert meta["acc_start"] == meta["iteration"] == 12
    assert meta["rng"] == "torch-philox"
    assert os.path.getsize(stripped) < os.path.getsize(full)
    with pytest.raises(ValueError, match="already state-only"):
        strip_checkpoint(stripped, str(tmp_path / "again.npz"))
    a = dt.fit(Y, cfg(stripped, 14, resume=True), device="cpu")
    b = dt.fit(Y, cfg(light, 14, resume=True), device="cpu")
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    assert np.isfinite(a.Sigma).all()


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_and_memmapped_inputs_fit_through_the_cli(tmp_path, fmt):
    """``--sparse`` reads a scipy ``save_npz`` file without scipy (a
    SparseMatrix that stays sparse: Sigma is not materialized) and
    ``--mmap`` a memmapped .npy, as the JAX CLI does."""
    sp = pytest.importorskip("scipy.sparse")
    Y, _ = make_synthetic(30, 8, 2, seed=5)
    Y[np.abs(Y) < 0.3] = 0.0
    path = str(tmp_path / "Y.npz")
    sp.save_npz(path, getattr(sp, f"{fmt}_matrix")(Y))
    Ys = port_cli._load(path, sparse=True)
    assert Ys.format == fmt and Ys.shape == Y.shape
    args = ["-g", "2", "-k", "4", "--burnin", "4", "--mcmc", "4",
            "--backend", "torch_cpu", "--fetch-dtype", "quant8"]
    got = _json(_cli("fit", path, "--sparse", *args,
                     "--out", str(tmp_path / "S.npy")))
    assert got["out"] is None and got["shape"] == [8, 8]
    np.save(tmp_path / "Y.npy", Y)
    got = _json(_cli("fit", str(tmp_path / "Y.npy"), "--mmap", *args,
                     "--materialize-sigma", "always",
                     "--out", str(tmp_path / "M.npy")))
    assert np.isfinite(np.load(got["out"])).all()
    with pytest.raises(SystemExit, match="scipy.sparse .npz"):
        port_cli._load(str(tmp_path / "Y.npy"), sparse=True)
