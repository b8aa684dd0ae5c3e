"""The port's HTTP server against the JAX package's, on one artifact.

For one fixed list of requests - entries, blocks (lists and ranges),
intervals, the 400 / 404 / 413 errors, 429 under backpressure and a
corrupt panel's typed 503 - the port's ``PosteriorServer`` (engine on
``device="cpu"``) and the JAX one answer with the same status, the same
JSON text and the same generation header.  ``/healthz`` has the same
keys apart from the port's ``device``, and the Prometheus exposition the
same serve metric families.  The CLI's ``serve --device cpu`` drains on
SIGTERM, serves identical values with the native assembler disabled, and
persists its hot set for a restart to prewarm.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.serve import server as jax_server_mod  # noqa: E402
from dcfm_tpu.serve.server import PosteriorServer as JaxServer  # noqa: E402
from dcfm_tpu_torch.serve import server as server_mod  # noqa: E402
from dcfm_tpu_torch.serve.artifact import (  # noqa: E402
    PosteriorArtifact, write_artifact)
from dcfm_tpu_torch.serve.server import (  # noqa: E402
    GENERATION_HEADER, PosteriorServer, _hotset_path)
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P_ORIG = 24
ZERO_COL = 5


def make_artifact(path, *, seed=0, p=P_ORIG, g=2, zero_col=ZERO_COL):
    """A small CRC'd artifact with random int8 panels and SD panels - no
    fit.  One all-zero input column (dropped, then padded back), and
    symmetric diagonal panels, as a real posterior's are."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((40, p)).astype(np.float32)
    if zero_col is not None:
        Y[:, zero_col] = 0.0
    pre = preprocess(Y, g)
    n_pairs = g * (g + 1) // 2
    P = pre.shard_size
    q = rng.integers(-127, 128, size=(n_pairs, P, P)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n_pairs).astype(np.float32)
    sd_q = rng.integers(1, 128, size=(n_pairs, P, P)).astype(np.int8)
    for r in range(g):
        d = r * g - (r * (r - 1)) // 2
        for panels in (q, sd_q):
            panels[d] = np.triu(panels[d]) + np.triu(panels[d], 1).T
    sd_scale = rng.uniform(0.5, 1.5, n_pairs).astype(np.float32)
    return write_artifact(path, mean_q8=q, mean_scale=scale, pre=pre,
                          sd_q8=sd_q, sd_scale=sd_scale).path


def _get(base, path, timeout=15):
    """-> (status, payload, headers) without raising on 4xx/5xx."""
    try:
        with urllib.request.urlopen(base + path, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    path = make_artifact(str(tmp_path_factory.mktemp("srv") / "art"))
    a = PosteriorArtifact.open(path)
    return a, a.assemble(), a.assemble(destandardize=False)


REQUESTS = [
    ("/v1/entry", {"i": ["0"], "j": ["1"]}),
    ("/v1/entry", {"i": ["7"], "j": ["19"]}),
    ("/v1/entry", {"i": ["19"], "j": ["7"], "destandardize": ["0"]}),
    ("/v1/entry", {"i": [str(ZERO_COL)], "j": ["9"]}),
    ("/v1/block", {"rows": ["0:6"], "cols": ["3,7,11,22"]}),
    ("/v1/block", {"rows": ["5,2"], "cols": [":"],
                   "destandardize": ["no"]}),
    ("/v1/block", {"rows": ["10:13"], "cols": ["0:24"], "kind": ["sd"]}),
    ("/v1/interval", {"i": ["2"], "j": ["7"], "alpha": ["0.1"]}),
    ("/v1/interval", {"i": ["12"], "j": ["12"], "destandardize": ["0"]}),
    ("/v1/entry", {"i": ["99999"], "j": ["0"]}),
    ("/v1/entry", {"i": ["abc"], "j": ["0"]}),
    ("/v1/entry", {"j": ["0"]}),
    ("/v1/block", {"rows": [""], "cols": ["1"]}),
    ("/v1/block", {"rows": ["0:99999"], "cols": ["1"]}),
    ("/v1/block", {"rows": ["1"]}),
    ("/v1/block", {"rows": ["1"], "cols": ["2"], "kind": ["bogus"]}),
    ("/v1/interval", {"i": ["0"], "j": ["0"], "alpha": ["2"]}),
    ("/nope", {}),
]


def _answers(srv, requests):
    out = []
    for path, q in requests:
        status, payload, headers = srv.handle(path, q)
        out.append((status, json.dumps(payload), headers[GENERATION_HEADER]))
    return out


def test_fixed_requests_answer_as_the_jax_server(art, tmp_path):
    a, _, _ = art
    port = PosteriorServer(a.path, port=0, max_queue=64, device="cpu")
    jax = JaxServer(a.path, port=0, max_queue=64)
    try:
        got, want = _answers(port, REQUESTS), _answers(jax, REQUESTS)
        assert got == want
        assert {s for s, _, _ in got} == {200, 400, 404}
        # 413: the block cap, lowered in both modules
        old = (server_mod.MAX_BLOCK_ENTRIES,
               jax_server_mod.MAX_BLOCK_ENTRIES)
        server_mod.MAX_BLOCK_ENTRIES = jax_server_mod.MAX_BLOCK_ENTRIES = 4
        try:
            req = [("/v1/block", {"rows": ["0:3"], "cols": ["0:3"]})]
            assert _answers(port, req) == _answers(jax, req)
            assert _answers(port, req)[0][0] == 413
        finally:
            (server_mod.MAX_BLOCK_ENTRIES,
             jax_server_mod.MAX_BLOCK_ENTRIES) = old
        # /healthz: the same keys and values, plus the port's device
        _, hp, _ = port.handle("/healthz", {})
        _, hj, _ = jax.handle("/healthz", {})
        assert hp.pop("device") == "cpu"
        hp.pop("uptime_s"), hj.pop("uptime_s")
        assert hp == hj
        # the JSON /metrics shape and the Prometheus serve families
        _, mp, _ = port.handle("/metrics", {})
        _, mj, _ = jax.handle("/metrics", {})
        assert set(mp) == set(mj)
        assert mp["statuses"] == mj["statuses"]
        assert mp["cache"] == mj["cache"] and mp["batcher"] == mj["batcher"]

        def families(text):
            return sorted(ln.split()[2] for ln in text.splitlines()
                          if ln.startswith("# TYPE dcfm_serve_"))

        _, pp, _ = port.handle("/metrics", {"format": ["prometheus"]})
        _, pj, _ = jax.handle("/metrics", {"format": ["prometheus"]})
        assert families(pp) == families(pj) and len(families(pp)) >= 10
    finally:
        port._httpd.server_close()
        port.batcher.close()
        jax._httpd.server_close()
        jax.batcher.close()


def test_corrupt_panel_is_the_same_typed_503(art, tmp_path):
    a, _, _ = art
    bad = str(tmp_path / "bad")
    shutil.copytree(a.path, bad)
    mm = np.memmap(os.path.join(bad, "mean_q8.bin"), dtype=np.int8,
                   mode="r+", shape=(a.n_pairs, a.P, a.P))
    mm[0, 0, 0] ^= 1
    mm.flush()
    del mm
    port = PosteriorServer(bad, port=0, device="cpu")
    jax = JaxServer(bad, port=0)
    try:
        i0 = next(i for i in range(P_ORIG)
                  if 0 <= port.engine.shard_index([i])[0] < a.P)
        reqs = [("/v1/entry", {"i": [str(i0)], "j": [str(i0)]}),
                ("/v1/block", {"rows": [str(i0)], "cols": ["0:24"]}),
                ("/v1/entry", {"i": ["20"], "j": ["21"]})]
        got = _answers(port, reqs)
        assert got == _answers(jax, reqs)
        body = json.loads(got[0][1])
        assert got[0][0] == 503 and body["corrupt_panel"] == 0
        assert "CRC32" in body["error"]
    finally:
        for s in (port, jax):
            s._httpd.server_close()
            s.batcher.close()


def test_backpressure_is_the_same_429(art):
    """The batch worker gated shut, the bounded queue full: both servers
    answer the overflow with 429 + retry (the jittered Retry-After aside)
    and the held requests with the same 200s.

    The test waits on conditions, never on a clock: the request deadline
    is far beyond any hold (a held request that expired while a loaded
    machine compiled the engine's first batch would answer 504), and the
    gate opens only after the 429 was seen."""
    a, ref, _ = art
    outcomes = []
    for cls, kw in ((PosteriorServer, {"device": "cpu"}), (JaxServer, {})):
        srv = cls(a.path, port=0, max_queue=2, max_batch=1,
                  request_timeout=600.0, **kw)
        gate, holding = threading.Event(), threading.Event()
        real = srv.batcher.engine

        class Gated:
            def entries(self, queries):
                holding.set()
                gate.wait()
                return real.entries(queries)

        srv.batcher.engine = Gated()
        results = []

        def one():
            results.append(srv.handle("/v1/entry",
                                      {"i": ["1"], "j": ["2"]}))

        threads = [threading.Thread(target=one)]
        threads[0].start()
        try:
            assert holding.wait(600.0)
            for _ in range(2):
                threads.append(threading.Thread(target=one))
                threads[-1].start()
            # both held requests are queued behind the gated batch (the
            # bound only stops a broken batcher from hanging the run)
            give_up = time.monotonic() + 600.0
            while srv.batcher.stats()["queue_depth"] < 2:
                assert time.monotonic() < give_up
                time.sleep(0.005)
            st, body, hdrs = srv.handle("/v1/entry",
                                        {"i": ["1"], "j": ["2"]})
            assert st == 429 and body["retry"] is True
            # [base, 2 * base) printed to the millisecond: a draw in
            # [0.0995, 0.1) prints as 0.100
            assert 0.05 <= float(hdrs["Retry-After"]) <= 0.1
            body.pop("retry_after")
        finally:
            gate.set()
            for t in threads:
                t.join()
            srv._httpd.server_close()
            srv.batcher.close()
        outcomes.append((st, body, sorted(
            (s, json.dumps(p)) for s, p, _ in results)))
    assert outcomes[0] == outcomes[1]
    assert [s for s, _ in outcomes[0][2]] == [200, 200, 200]
    assert np.float32(json.loads(outcomes[0][2][0][1])["value"]) == \
        np.float32(ref[1, 2])


def test_entry_block_interval_over_http_bitwise(art):
    a, ref, ref_raw = art
    srv = PosteriorServer(a, port=0, device="cpu")
    host, port = srv.start()
    base = f"http://{host}:{port}"
    try:
        rng = np.random.default_rng(0)
        for _ in range(30):
            i, j = (int(v) for v in rng.integers(0, a.p_original, 2))
            st, e, h = _get(base, f"/v1/entry?i={i}&j={j}")
            assert st == 200 and h[GENERATION_HEADER] == "0"
            assert np.float32(e["value"]) == np.float32(ref[i, j])
        st, e, _ = _get(base, "/v1/entry?i=1&j=2&destandardize=0")
        assert np.float32(e["value"]) == np.float32(ref_raw[1, 2])
        st, b, _ = _get(base, "/v1/block?rows=0:6&cols=3,7,11,22")
        np.testing.assert_array_equal(
            np.asarray(b["values"], np.float32),
            ref[np.ix_(b["rows"], b["cols"])])
        st, iv, _ = _get(base, "/v1/interval?i=2&j=7&alpha=0.1")
        assert st == 200 and np.float32(iv["mean"]) == np.float32(ref[2, 7])
        st, h, _ = _get(base, "/healthz")
        assert st == 200 and h["device"] == "cpu"
    finally:
        srv.close()


def _spawn_cli_serve(path, extra_env=None, extra=()):
    env = dict(os.environ, **(extra_env or {}))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve", path,
         "--port", "0", "--device", "cpu", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env=env)
    line = proc.stdout.readline()
    assert line, proc.stderr.read()
    return proc, json.loads(line)


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError("serve did not drain")
    return out, err


@pytest.mark.parametrize("native_off", [False, True])
def test_cli_serve_drains_on_sigterm_and_degraded_serves_the_same(
        art, native_off):
    a, ref, _ = art
    env = {"DCFM_NATIVE_DISABLE": "1"} if native_off else {}
    proc, info = _spawn_cli_serve(a.path, env)
    try:
        assert info["device"] == "cpu" and info["p"] == P_ORIG
        base = info["serving"]
        st, h, _ = _get(base, "/healthz")
        assert st == 200 and h["device"] == "cpu"
        assert h["native"] is (not native_off)
        assert h["status"] == ("degraded" if native_off else "ok")
        rng = np.random.default_rng(3)
        for _ in range(12):
            i, j = (int(v) for v in rng.integers(0, a.p_original, 2))
            st, e, _ = _get(base, f"/v1/entry?i={i}&j={j}")
            assert st == 200 and np.float32(e["value"]) == np.float32(
                ref[i, j])
        st, b, _ = _get(base, "/v1/block?rows=0:5&cols=0:5")
        np.testing.assert_array_equal(np.asarray(b["values"], np.float32),
                                      ref[:5, :5])
        out, err = _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
    last = json.loads(out.strip().splitlines()[-1])
    assert last["drained"] is True and last["statuses"]["200"] >= 14


def test_hot_set_persisted_and_prewarmed_on_restart(art, tmp_path):
    a, ref, _ = art
    path = str(tmp_path / "art")
    shutil.copytree(a.path, path)
    srv = PosteriorServer(path, port=0, device="cpu")
    srv.start()
    try:
        assert srv._prewarmed == 0
        for _ in range(5):
            srv.handle("/v1/entry", {"i": ["0"], "j": ["1"]})
    finally:
        srv.close()
    assert os.path.exists(_hotset_path(path))
    with open(_hotset_path(path)) as f:
        hot = json.load(f)
    proc, info = _spawn_cli_serve(path)
    try:
        st, m, _ = _get(info["serving"], "/metrics")
        assert m["cache"]["panels"] == len(hot) >= 1
        misses = m["cache"]["misses"]
        st, e, _ = _get(info["serving"], "/v1/entry?i=0&j=1")
        assert np.float32(e["value"]) == np.float32(ref[0, 1])
        st, m, _ = _get(info["serving"], "/metrics")
        assert m["cache"]["misses"] == misses      # served warm
        _stop(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0


def test_sparse_artifact_is_the_jax_packages_and_serves_zeros(tmp_path):
    """``create_sparse_artifact`` writes the JAX package's files byte for
    byte (hole-backed panels, identity maps, no CRCs) and serves exact
    zeros until panel bytes are patched in."""
    from dcfm_tpu.serve.artifact import create_sparse_artifact as jax_sparse
    from dcfm_tpu_torch.serve.artifact import create_sparse_artifact
    from dcfm_tpu_torch.serve.engine import QueryEngine
    a = create_sparse_artifact(str(tmp_path / "t"), g=5, P=7, has_sd=True)
    b = jax_sparse(str(tmp_path / "j"), g=5, P=7, has_sd=True)
    for name in sorted(os.listdir(a)):
        with open(os.path.join(a, name), "rb") as x, \
                open(os.path.join(b, name), "rb") as y:
            assert x.read() == y.read(), name
    art = PosteriorArtifact.open(a)
    eng = QueryEngine(art, device="cpu")
    assert eng.entry(3, 30) == np.float32(0.0)
    assert not eng.block(np.arange(35), np.arange(35), kind="sd").any()
    mm = np.memmap(os.path.join(a, "mean_q8.bin"), dtype=np.int8, mode="r+",
                   shape=(15, 7, 7))
    mm[0, 1, 2] = mm[0, 2, 1] = 127
    mm.flush()
    del mm
    assert eng.entry(1, 2) == np.float32(1.0)     # scale 1: 127 * 1/127


_NATIVE_PROBE = r"""
import numpy as np
from dcfm_tpu_torch import native
from dcfm_tpu_torch.utils.estimate import assemble_from_q8
from dcfm_tpu_torch.utils.preprocess import preprocess
rng = np.random.default_rng(0)
pre = preprocess(rng.standard_normal((20, 12)).astype(np.float32), 2)
q = rng.integers(-127, 128, (3, 6, 6)).astype(np.int8)
s = rng.uniform(0.5, 1.5, 3).astype(np.float32)
S = assemble_from_q8(q, s, pre)
print(native.available(), native.sanitize_requested(), native.library_path(),
      S.view(np.int32).sum())
"""


def test_native_switches_disable_and_sanitize():
    """DCFM_NATIVE_DISABLE=1 turns the assembler off; DCFM_NATIVE_SANITIZE=1
    selects a separate ASan+UBSan library, loaded only when the ASan
    runtime is preloaded (else the NumPy path); every lane assembles the
    same bits."""
    def probe(**env):
        cp = subprocess.run([sys.executable, "-c", _NATIVE_PROBE],
                            capture_output=True, text=True, cwd=REPO,
                            timeout=300, env=dict(os.environ, **env))
        assert cp.returncode == 0, cp.stderr[-2000:]
        return cp.stdout.split()

    plain = probe()
    assert plain[:2] == ["True", "False"]
    off = probe(DCFM_NATIVE_DISABLE="1")
    assert off[:2] == ["False", "False"] and off[3] == plain[3]
    no_rt = probe(DCFM_NATIVE_SANITIZE="1")
    assert no_rt[:2] == ["False", "True"] and no_rt[2] != plain[2]
    asan = subprocess.run(["gcc", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(asan) or not os.path.exists(asan):
        pytest.skip("no ASan runtime beside gcc")
    san = probe(DCFM_NATIVE_SANITIZE="1", LD_PRELOAD=asan,
                ASAN_OPTIONS="detect_leaks=0")
    assert san == ["True", "True", no_rt[2], plain[3]]
