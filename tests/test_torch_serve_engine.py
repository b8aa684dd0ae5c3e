"""The port's query engine and microbatcher against the JAX package's.

The same artifact - exported by each package in turn from a fit of its
own - is opened by both ``QueryEngine`` classes, the port's on
``device="cpu"``; every served value (entries, batched entries, blocks,
rows, SD entries, intervals; with and without de-standardization; zero
columns too) must equal the JAX engine's and the offline
``PosteriorArtifact.assemble()``'s BIT FOR BIT, and the same query
sequence must leave the same cache counters under a budget that evicts.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu.serve.artifact import PosteriorArtifact as JaxArtifact  # noqa: E402
from dcfm_tpu.serve.engine import QueryEngine as JaxEngine  # noqa: E402
from dcfm_tpu_torch.serve.artifact import (  # noqa: E402
    ArtifactCorruptError, PosteriorArtifact, export_fit_result)
from dcfm_tpu_torch.serve.batcher import (  # noqa: E402
    DeadlineExceeded, Overloaded, QueryBatcher)
from dcfm_tpu_torch.serve.engine import QueryEngine, _norm_ppf  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

ZERO_COL = 3


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _fit_and_export(pkg: str, path: str):
    """A posterior-SD quant8 fit of the shared data by ``pkg``, exported by
    the same package (p = 26 over 2 shards, one all-zero column)."""
    Y, _ = make_synthetic(n=30, p=26, k_true=3, seed=7)
    Y[:, ZERO_COL] = 0.0
    mod = dt if pkg == "port" else dcfm_tpu
    cfg = mod.FitConfig(
        model=mod.ModelConfig(num_shards=2, factors_per_shard=3, rho=0.9,
                              posterior_sd=True),
        run=mod.RunConfig(burnin=16, mcmc=16, thin=2, seed=0),
        backend=mod.BackendConfig(fetch_dtype="quant8"))
    if pkg == "port":
        export_fit_result(dt.fit(Y, cfg, device="cpu"), path)
    else:
        from dcfm_tpu.serve.artifact import export_fit_result as jax_export
        jax_export(dcfm_tpu.fit(Y, cfg), path)
    return path


@pytest.fixture(scope="module", params=["port", "jax"])
def served(request, tmp_path_factory):
    """(port artifact, JAX artifact, offline references) of one export."""
    path = _fit_and_export(request.param,
                           str(tmp_path_factory.mktemp("eng") / "art"))
    art, jart = PosteriorArtifact.open(path), JaxArtifact.open(path)
    refs = {(kind, d): art.assemble(kind=kind, destandardize=d)
            for kind in ("mean", "sd") for d in (True, False)}
    for key, ref in refs.items():       # the two packages' assemblies agree
        np.testing.assert_array_equal(
            _bits(ref), _bits(jart.assemble(kind=key[0],
                                            destandardize=key[1])))
    return art, jart, refs


def _pairs(rng, p, n):
    return [tuple(int(v) for v in rng.integers(0, p, 2)) for _ in range(n)]


@pytest.mark.parametrize("destandardize", [True, False])
def test_entries_bitwise_the_jax_engine_and_the_assembly(served,
                                                         destandardize):
    art, jart, refs = served
    eng, jeng = QueryEngine(art, device="cpu"), JaxEngine(jart)
    ref = refs[("mean", destandardize)]
    for kind in ("mean", "sd"):
        ref = refs[(kind, destandardize)]
        for i, j in _pairs(np.random.default_rng(0), art.p_original, 120):
            got = eng.entry(i, j, kind=kind, destandardize=destandardize)
            assert type(got) is np.float32
            want = jeng.entry(i, j, kind=kind, destandardize=destandardize)
            assert _bits(got) == _bits(want) == _bits(ref[i, j]), (kind, i, j)
    # the microbatcher's path: mixed flags, zero columns among them
    rng = np.random.default_rng(1)
    qs = [(i, j, bool(f)) for (i, j), f in zip(
        _pairs(rng, art.p_original, 90), rng.integers(0, 2, 90))]
    qs += [(ZERO_COL, 5, True), (5, ZERO_COL, False),
           (ZERO_COL, ZERO_COL, True)]
    got, want = eng.entries(qs), jeng.entries(qs)
    assert all(type(v) is np.float32 for v in got)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits([refs[("mean", f)][i, j] for i, j, f in qs]))
    assert eng.entries([(ZERO_COL, 1, True)]) == [np.float32(0.0)]


def test_blocks_rows_sd_and_zero_columns_bitwise(served):
    art, jart, refs = served
    eng, jeng = QueryEngine(art, device="cpu"), JaxEngine(jart)
    rng = np.random.default_rng(2)
    rows = np.concatenate([rng.integers(0, art.p_original, 9), [ZERO_COL]])
    cols = np.concatenate([[ZERO_COL], rng.integers(0, art.p_original, 7)])
    for kind in ("mean", "sd"):
        for d in (True, False):
            got = eng.block(rows, cols, kind=kind, destandardize=d)
            assert got.dtype == np.float32 and got.shape == (10, 8)
            np.testing.assert_array_equal(
                _bits(got), _bits(jeng.block(rows, cols, kind=kind,
                                             destandardize=d)))
            np.testing.assert_array_equal(
                _bits(got), _bits(refs[(kind, d)][np.ix_(rows, cols)]))
            np.testing.assert_array_equal(
                _bits(eng.row(5, kind=kind, destandardize=d)),
                _bits(refs[(kind, d)][5]))
    assert not eng.block([ZERO_COL], [ZERO_COL, 1]).any()
    assert eng.entry(ZERO_COL, ZERO_COL) == np.float32(0.0)
    for i, j in ((2, 7), (ZERO_COL, 4), (11, 11)):
        for alpha in (0.05, 0.2):
            for d in (True, False):
                assert eng.interval(i, j, alpha=alpha, destandardize=d) == \
                    jeng.interval(i, j, alpha=alpha, destandardize=d)
    mean, sd, lo, hi = eng.interval(6, 8, alpha=0.05)
    assert lo < mean < hi and sd > 0
    assert _norm_ppf(0.975) == pytest.approx(1.959964, abs=5e-6)


def test_evicting_cache_counters_replay_as_in_the_jax_engine(served):
    """One query sequence (entries, batches, blocks, rows, SD, intervals)
    under a two-panel budget: the same hits, misses, evictions, panels
    and hot set after every step, and bytes counted on the device."""
    art, jart, _ = served
    budget = 2 * art.P * art.P * 4
    eng = QueryEngine(art, device="cpu", cache_bytes=budget)
    jeng = JaxEngine(jart, cache_bytes=budget)
    rng = np.random.default_rng(3)
    steps = []
    for _ in range(6):
        steps.append(("entries", [(i, j, True) for i, j in
                                  _pairs(rng, art.p_original, 17)]))
        steps.append(("entry", _pairs(rng, art.p_original, 1)[0]))
        steps.append(("block", (rng.integers(0, art.p_original, 5),
                                rng.integers(0, art.p_original, 4))))
        steps.append(("sd", _pairs(rng, art.p_original, 1)[0]))
        steps.append(("interval", _pairs(rng, art.p_original, 1)[0]))
    steps.append(("row", 9))
    for what, q in steps:
        for e in (eng, jeng):
            if what == "entries":
                e.entries(q)
            elif what == "entry":
                e.entry(*q)
            elif what == "block":
                e.block(*q)
            elif what == "sd":
                e.sd_entry(*q)
            elif what == "interval":
                e.interval(*q)
            else:
                e.row(q)
        assert eng.stats() == jeng.stats(), what
    s = eng.stats()
    assert s["evictions"] > 0 and s["bytes"] <= budget
    assert sum(p.numel() * p.element_size()
               for _, p in eng.cache.snapshot()) == s["bytes"]
    assert eng.hot_panels(8) == jeng.hot_panels(8)


def _corrupt_copy(art, dst, pair=0):
    shutil.copytree(art.path, dst)
    mm = np.memmap(os.path.join(dst, "mean_q8.bin"), dtype=np.int8,
                   mode="r+", shape=(art.n_pairs, art.P, art.P))
    mm[pair, 0, 0] ^= 1
    mm.flush()
    del mm
    return PosteriorArtifact.open(dst)


def _caller_in_shard(eng, shard):
    for i in range(eng.artifact.p_original):
        si = int(eng.shard_index([i])[0])
        if si >= 0 and si // eng.artifact.P == shard:
            return i
    raise AssertionError("no column maps to the shard")


def test_corrupt_panel_raises_typed_on_first_touch_and_after_eviction(
        served, tmp_path):
    art, _, refs = served
    bad = _corrupt_copy(art, str(tmp_path / "bad"))
    eng = QueryEngine(bad, device="cpu",
                      cache_bytes=bad.P * bad.P * 4)     # one panel
    i0, i1 = _caller_in_shard(eng, 0), _caller_in_shard(eng, 1)
    assert _bits(eng.entry(i1, i1)) == _bits(refs[("mean", True)][i1, i1])
    for _ in range(2):          # never cached: the retry raises again
        with pytest.raises(ArtifactCorruptError) as ei:
            eng.entry(i0, i0)
        assert ei.value.panel == 0 and ei.value.kind == "mean"
    with pytest.raises(ArtifactCorruptError):
        eng.entries([(i1, i1, True), (i0, i0, True)])
    # an eviction makes a panel re-verified on its next touch: rot a
    # healthy panel after it was cached, evict it, touch it again
    eng2 = QueryEngine(bad, device="cpu", cache_bytes=bad.P * bad.P * 4)
    assert _bits(eng2.entry(i1, i1)) == _bits(refs[("mean", True)][i1, i1])
    mm = np.memmap(os.path.join(bad.path, "mean_q8.bin"), dtype=np.int8,
                   mode="r+", shape=(bad.n_pairs, bad.P, bad.P))
    mm[2, 1, 1] ^= 1
    mm.flush()
    del mm
    assert _bits(eng2.entry(i1, i1)) == _bits(refs[("mean", True)][i1, i1])
    eng2.entry(i0, i1)                       # panel 1 evicts panel 2
    with pytest.raises(ArtifactCorruptError) as ei:
        eng2.entry(i1, i1)
    assert ei.value.panel == 2


def test_hot_panels_prewarm_and_stale_keys(served):
    art, jart, refs = served
    hot = QueryEngine(art, device="cpu")
    c0, c1 = _caller_in_shard(hot, 0), _caller_in_shard(hot, 1)
    for _ in range(10):
        hot.entry(c0, c0)
    hot.entry(c1, c1)
    assert hot.hot_panels(8) == [("mean", 0), ("mean", 2)]
    cold = QueryEngine(art, device="cpu")
    assert cold.prewarm(hot.hot_panels(8)) == 2
    jcold = JaxEngine(jart)
    assert jcold.prewarm(hot.hot_panels(8)) == 2
    assert cold.stats() == jcold.stats()
    misses = cold.stats()["misses"]
    assert _bits(cold.entry(c0, c0)) == _bits(refs[("mean", True)][c0, c0])
    assert cold.stats()["misses"] == misses
    assert cold.prewarm([("mean", 99), ("nope", 0)]) == 0


def _rescaled_copy(art, dst, pairs, scale_only=False):
    """Copy ``art``; change ``pairs``' mean bytes (or only their scale),
    re-recording CRCs and the fingerprint."""
    import json

    from dcfm_tpu_torch.serve.artifact import (
        artifact_fingerprint, panel_crc32)
    shutil.copytree(art.path, dst)
    if scale_only:
        with np.load(os.path.join(dst, "maps.npz")) as z:
            maps = {k: z[k] for k in z.files}
        maps["mean_scale"] = maps["mean_scale"].copy()
        maps["mean_scale"][list(pairs)] *= np.float32(2.0)
        np.savez(os.path.join(dst, "maps.npz"), **maps)
    else:
        mm = np.memmap(os.path.join(dst, "mean_q8.bin"), dtype=np.int8,
                       mode="r+", shape=(art.n_pairs, art.P, art.P))
        for pair in pairs:
            mm[pair] = -mm[pair]
        mm.flush()
        with open(os.path.join(dst, "meta.json")) as f:
            meta = json.load(f)
        meta["panel_crc"]["mean"] = [int(panel_crc32(np.asarray(q)))
                                     for q in mm]
        meta["fingerprint"] = artifact_fingerprint(meta)
        with open(os.path.join(dst, "meta.json"), "w") as f:
            json.dump(meta, f)
        del mm
    return PosteriorArtifact.open(dst)


def test_adoption_of_unchanged_pairs_and_scale_only_changes(served,
                                                            tmp_path):
    art, _, _ = served
    old = QueryEngine(art, device="cpu")
    for pair_rc in ((0, 0), (0, 1), (1, 1)):
        old.prewarm([("mean", old._pair(*pair_rc)), ("sd",
                                                     old._pair(*pair_rc))])
    new_art = _rescaled_copy(art, str(tmp_path / "v2"), pairs=(1,))
    new = QueryEngine(new_art, device="cpu", adopt_from=old)
    assert new.panel_source("mean", 1) == "new"
    assert new.panel_source("mean", 0) == "adopted"
    assert new.panels_adopted == 2 + 3 and new.cache_seeded == 2 + 3
    ref = new_art.assemble()
    for i, j in _pairs(np.random.default_rng(4), art.p_original, 60):
        assert _bits(new.entry(i, j)) == _bits(ref[i, j])
    jnew = JaxEngine(JaxArtifact.open(new_art.path),
                     adopt_from=JaxEngine(JaxArtifact.open(art.path)))
    assert jnew.panels_adopted == new.panels_adopted
    # a scale-only change keeps the bytes (and the CRCs) but defeats
    # adoption of that pair: its served values change
    sc = _rescaled_copy(art, str(tmp_path / "v3"), pairs=(2,),
                        scale_only=True)
    eng = QueryEngine(sc, device="cpu", adopt_from=old)
    assert eng.panel_source("mean", 2) == "new"
    assert eng.panel_source("mean", 0) == "adopted"
    ref = sc.assemble()
    c1 = _caller_in_shard(eng, 1)
    assert _bits(eng.entry(c1, c1)) == _bits(ref[c1, c1])


def test_default_device_is_the_card_and_refuses_without_one(served):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default engine runs on it")
    art, _, _ = served
    with pytest.raises(RuntimeError, match="no fallback"):
        QueryEngine(art)


# ---- the microbatcher --------------------------------------------------

def test_batcher_coalesces_by_panel(served):
    art, _, refs = served
    b = QueryBatcher(QueryEngine(art, device="cpu"), max_queue=128,
                     max_batch=64)
    try:
        pairs = _pairs(np.random.default_rng(5), art.p_original, 40)
        results = {}

        def one(i, j):
            results[(i, j)] = b.entry(i, j)

        threads = [threading.Thread(target=one, args=p) for p in pairs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for (i, j), v in results.items():
            assert _bits(v) == _bits(refs[("mean", True)][i, j])
        st = b.stats()
        assert st["served"] == len(pairs) and st["rejected"] == 0
        assert 1 <= st["batches"] <= len(pairs)
    finally:
        b.close()


class _SlowEngine:
    """Engine shim whose batch blocks until released, and which signals
    the moment the batcher's worker holds a batch."""

    def __init__(self, engine):
        self._engine = engine
        self.gate = threading.Event()
        self.holding = threading.Event()

    def entries(self, queries):
        self.holding.set()
        self.gate.wait(10.0)
        return self._engine.entries(queries)


def _swallow(b, i=1, j=2, timeout=None):
    try:
        b.entry(i, j, timeout=timeout)
    except Exception:   # noqa: BLE001 - the holders' outcomes are not tested
        pass


def test_batcher_backpressure_rejects_when_full(served):
    """Deterministic: the worker is known to hold the first request
    (``holding``) before the queue is filled to ``max_queue``, so the next
    request can only be rejected."""
    art, _, _ = served
    slow = _SlowEngine(QueryEngine(art, device="cpu"))
    b = QueryBatcher(slow, max_queue=2, max_batch=1, default_timeout=10.0)
    holders = []
    try:
        first = threading.Thread(target=_swallow, args=(b,))
        first.start()
        holders.append(first)
        assert slow.holding.wait(10.0), "the worker never took a request"
        for _ in range(2):
            t = threading.Thread(target=_swallow, args=(b,))
            t.start()
            holders.append(t)
        deadline = time.monotonic() + 10.0
        while (b.stats()["queue_depth"] < 2
               and time.monotonic() < deadline):
            time.sleep(0.005)
        assert b.stats()["queue_depth"] == 2
        with pytest.raises(Overloaded):
            b.entry(0, 0)
        assert b.stats()["rejected"] == 1
    finally:
        slow.gate.set()
        for t in holders:
            t.join(timeout=30)
        b.close()
    assert not any(t.is_alive() for t in holders)
    assert b.stats()["served"] == 3


def test_batcher_expires_stale_requests(served):
    art, _, _ = served
    slow = _SlowEngine(QueryEngine(art, device="cpu"))
    b = QueryBatcher(slow, max_queue=8, max_batch=4)
    try:
        t = threading.Thread(target=_swallow, args=(b,))
        t.start()
        assert slow.holding.wait(10.0)
        err = []

        def stale():
            try:
                b.entry(2, 3, timeout=0.05)
            except DeadlineExceeded:
                err.append("deadline")

        t2 = threading.Thread(target=stale)
        t2.start()
        time.sleep(0.3)                 # the deadline lapses while queued
        slow.gate.set()
        t.join(timeout=30)
        t2.join(timeout=30)
        assert err == ["deadline"]
        assert b.stats()["expired"] >= 1
    finally:
        slow.gate.set()
        b.close()


def test_queries_spanning_several_stacks_are_the_same(served, monkeypatch):
    """A query whose panels outnumber one stack (``_STACK``) is gathered
    stack by stack into the same answer, with the same cache counters."""
    from dcfm_tpu_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "_STACK", 1)
    art, jart, refs = served
    budget = 2 * art.P * art.P * 4
    eng = QueryEngine(art, device="cpu", cache_bytes=budget)
    jeng = JaxEngine(jart, cache_bytes=budget)
    rng = np.random.default_rng(6)
    qs = [(i, j, bool(f)) for (i, j), f in zip(
        _pairs(rng, art.p_original, 60), rng.integers(0, 2, 60))]
    np.testing.assert_array_equal(_bits(eng.entries(qs)),
                                  _bits(jeng.entries(qs)))
    rows = rng.integers(0, art.p_original, 12)
    for kind in ("mean", "sd"):
        np.testing.assert_array_equal(
            _bits(eng.block(rows, rows[::-1], kind=kind)),
            _bits(jeng.block(rows, rows[::-1], kind=kind)))
    np.testing.assert_array_equal(_bits(eng.row(4)),
                                  _bits(refs[("mean", True)][4]))
    jeng.row(4)
    assert eng.stats() == jeng.stats()
