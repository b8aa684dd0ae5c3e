"""The port's profiler ranges and stage timers (dcfm_tpu_torch/profiling.py),
on the CPU: a fit under ``BackendConfig.profile_dir`` names each phase and
each step of its chain as a range and changes no bit; an unprofiled fit
opens no range and times nothing; and the stage boundaries a trip's timed
twin stamps come in sweep order and tile the trip, here recorded by a stub
timer that reads an operation counter instead of the card's clock (the
card tests in tests/test_torch_gpu.py read the events).
"""

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import profiling  # noqa: E402
from dcfm_tpu_torch.models.sampler import (  # noqa: E402
    save_pattern, trace_runner)
from tests.conftest import make_synthetic  # noqa: E402

PHASES = ("api.preprocess", "api.upload", "api.init", "api.chain",
          "api.fetch", "api.assemble")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg(**backend):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=3, factors_per_shard=3, rho=0.8),
        run=dt.RunConfig(burnin=6, mcmc=6, thin=2, seed=0, num_chains=2,
                         chunk_size=6),
        backend=dt.BackendConfig(**backend), obs="off")


def _trace_events(prof_dir) -> list:
    (name,) = [f for f in os.listdir(prof_dir)
               if f.endswith(".pt.trace.json")]
    with open(os.path.join(prof_dir, name)) as f:
        return json.load(f)["traceEvents"]


def test_a_profiled_fit_names_its_phases_and_chain_steps(tmp_path):
    """Every phase of a post-hoc float32 fit is one range, the chain's
    eager trips and their draws are ranges inside ``api.chain``, each
    chunk's end an ``api.chain.boundary``; no ``trip`` range is left; the
    profiler changes no bit of Sigma."""
    Y, _ = make_synthetic(40, 24, 2, seed=1)
    prof = tmp_path / "prof"
    traced = dt.fit(Y, _cfg(profile_dir=str(prof)), device="cpu")
    plain = dt.fit(Y, _cfg(), device="cpu")
    np.testing.assert_array_equal(traced.Sigma, plain.Sigma)
    events = [e for e in _trace_events(prof)
              if e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    for phase in PHASES:
        assert names.count(phase) == 1, phase
    assert "trip" not in names
    # 12 iterations a chain in chunks of 6, trips of 1: the first trip
    # records the recipe, every later one is drawn first
    assert names.count("api.chain.eager") == 2 * 12
    assert names.count("api.chain.draw") == 2 * 12 - 1
    assert names.count("api.chain.boundary") == 2 * 2
    (chain,) = [e for e in events if e["name"] == "api.chain"]
    for e in events:
        if e["name"].startswith("api.chain."):
            assert chain["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= chain["ts"] + chain["dur"]
    # the phases in the fit's order, none inside another
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e["name"] in PHASES)
    assert [s[2] for s in spans] == list(PHASES)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_an_unprofiled_fit_opens_no_range_and_times_nothing(monkeypatch):
    """With no profiler recording, no range is made (the range maker
    raises here) and nothing is timed; the CPU never times a stage."""
    def refuse(*a, **k):
        raise AssertionError("a range was opened with no profiler on")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    Y, _ = make_synthetic(40, 24, 2, seed=1)
    res = dt.fit(Y, _cfg(), device="cpu")
    assert res.graphs["stage_ms"] == {}
    assert res.graphs["stage_samples"] == 0
    assert set(res.phase_seconds) == {
        "preprocess_s", "upload_s", "init_s", "checkpoint_s", "chain_s",
        "fetch_s", "assemble_s", "exposed_fetch_s"}


class _OpCount(TorchDispatchMode):
    """Counts the aten operations run under it: the stub timer's clock."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


class _StubEvent:
    def __init__(self, ops: _OpCount):
        self._ops, self.t = ops, None

    def record(self):
        self.t = self._ops.n

    def elapsed_time(self, other) -> float:
        return float(other.t - self.t)


SWEEP = ["z_update", "x_update", "lambda_update", "prior_update",
         "ps_update"]
MODELS = {
    "mgp": dict(),
    "horseshoe-adapt": dict(prior="horseshoe", rank_adapt=True),
    "mgp-missing": dict(impute_missing=True),
}


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("start", [0, 2])
def test_stage_boundaries_come_in_sweep_order_and_tile_the_trip(model,
                                                                 start):
    """A trip of 2 sweeps, with the boundaries a timed twin's capture
    stamps (profiling.StageClock) made by a stub timer on an
    operation counter: the stages in sweep order, each followed by
    ``other``; the first mark before the trip's first operation, the last
    after its last, so the intervals tile the trip; the combine only in a
    trip that saves (burn-in 2, thin 2: the trip from 0 saves nothing,
    the trip from 2 saves its second sweep); every stage does work."""
    cfg = dt.ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8,
                         **MODELS[model])
    runner = trace_runner("cpu", cfg, 2)
    runner.init_chain(0)
    runner._trip(0, 0, save_pattern(0, 2, 2, 2))       # the recipe trip
    pattern = save_pattern(start, 2, 2, 2)
    assert pattern == ((False, False) if start == 0 else (False, True))
    runner._write_its(start, 2)
    draws = runner._predrawn(0, start, 2)
    ops = _OpCount()
    clock = profiling.StageClock(2, sum(pattern),
                                 event=lambda: _StubEvent(ops))
    with ops, clock.timing():
        runner._sweeps(draws, pattern)
    total = ops.n
    labels = [label for label, _ in clock.marks]
    want = []
    for saves in pattern:
        want += (["impute_missing"] if cfg.impute_missing else []) + SWEEP
        want += (["adapt_rank"] if cfg.rank_adapt else [])
        want += (["combine"] if saves else []) + ["health_trace"]
    assert labels[0] == profiling.OTHER and labels[-1] is None
    assert labels[1:-1:2] == want
    assert all(label == profiling.OTHER for label in labels[2:-1:2])
    times = [ev.t for _, ev in clock.marks]
    assert times[0] == 0 and times[-1] == total
    assert times == sorted(times)
    spans = clock.intervals()
    assert sum(spans.values()) == total
    assert set(spans) == set(want) | {profiling.OTHER}
    assert all(spans[s] > 0 for s in want)
    assert ("combine" in spans) == any(pattern)


def test_the_tally_means_a_sweep_and_a_saved_draw():
    """stage_ms: each stage's device ms over the sweeps of the sampled
    replays that ran it, the combine's over their saved draws; merged
    tallies (a rewind's runners) add up."""
    class Fixed:
        def __init__(self, t):
            self.t = t

        def record(self):
            pass

        def elapsed_time(self, other):
            return other.t - self.t

    def clock(sweeps, saves, spans):
        c = profiling.StageClock(sweeps, saves)
        t = 0.0
        for label, ms in spans:
            c.marks.append((label, Fixed(t)))
            t += ms
        c.marks.append((None, Fixed(t)))
        return c

    a, b = profiling.StageTally(), profiling.StageTally()
    a.add(clock(2, 1, [("other", 0.5), ("z_update", 2.0), ("combine", 3.0),
                       ("z_update", 2.0)]))
    b.add(clock(1, 0, [("z_update", 1.0), ("other", 0.5)]))
    a.merge(b)
    assert a.samples == 2
    assert a.means() == pytest.approx(
        {"other": 1.0 / 3, "z_update": 5.0 / 3, "combine": 3.0})


class _Tick:
    """A stub timing event: each record reads the next tick of a shared
    counter, so every interval between two marks is positive."""

    def __init__(self, ticks):
        self._ticks, self.t = ticks, None

    def record(self):
        self.t = next(self._ticks)

    def elapsed_time(self, other) -> float:
        return float(other.t - self.t)


def test_a_nested_stage_counts_under_its_label_and_its_parents():
    """A stage opened inside an open one marks its bounds and hands the
    clock back to the enclosing stage, not to ``other``; the enclosing
    stage's total includes it, and the outermost labels tile the trip."""
    import itertools

    ticks = itertools.count()
    clock = profiling.StageClock(1, 0, event=lambda: _Tick(ticks))
    with clock.timing():
        with profiling.scope("z_update"):
            pass
        with profiling.scope("prior_update"):
            for _ in range(2):
                with profiling.scope("gig"):
                    pass
    labels = [label for label, _ in clock.marks]
    assert labels == [profiling.OTHER, "z_update", profiling.OTHER,
                      "prior_update", "gig", "prior_update", "gig",
                      "prior_update", profiling.OTHER, None]
    assert clock.nested == {"gig": ("prior_update",)}
    spans = clock.intervals()
    # ticks 0 .. 9: gig holds [4, 5) and [6, 7), prior_update [3, 8)
    assert spans == {profiling.OTHER: 3.0, "z_update": 1.0,
                     "prior_update": 5.0, "gig": 2.0}
    assert sum(v for k, v in spans.items() if k not in clock.nested) == 9.0
    # the GIG's counts add up over calls (and replays) until read, then
    # restart; a trip that runs no GIG reads none
    assert profiling.StageClock(1, 0).gig_counts() == {}
    clock.count_gig(torch.tensor([1, 2, 3, 4]))
    clock.count_gig(torch.tensor([5, 6, 7, 8]))
    tally = profiling.StageTally()
    tally.add(clock)
    assert tally.means()["gig"] == 2.0
    assert tally.gig == dict(zip(profiling.GIG_COUNTS, [6, 8, 10, 12]))
    assert clock.gig_counts() == dict.fromkeys(profiling.GIG_COUNTS, 0)


def _timed_sweeps(monkeypatch):
    """Every trip of the fits that follow runs as a timed twin would: under
    a StageClock of stub events, added to its runner's tally (a CPU fit
    captures no twin; the card tests time the real ones)."""
    import itertools

    from dcfm_tpu_torch.models.sampler import ChainRunner

    ticks = itertools.count()
    sweeps = ChainRunner._sweeps

    def timed(self, draws, pattern):
        clock = profiling.StageClock(len(pattern), sum(pattern),
                                     event=lambda: _Tick(ticks))
        with clock.timing():
            sweeps(self, draws, pattern)
        self.stages.add(clock)

    monkeypatch.setattr(ChainRunner, "_sweeps", timed)


@pytest.mark.parametrize("prior", ["mgp", "horseshoe", "dl"])
def test_a_timed_fit_reports_the_gig_of_the_dl_prior_only(prior,
                                                          monkeypatch):
    """Timed trips of a DL fit add the stage ``gig`` inside
    ``prior_update`` and the GIG's counters to ``FitResult.graphs``: per
    sweep and chain G P K draws of phi's T and G P of tau, 64 rounds
    each.  MGP and horseshoe fits keep their stages and carry no ``gig``.
    Timing changes no bit, and an untimed fit has neither key."""
    def cfg():
        c = _cfg()
        return dataclasses.replace(c, model=dataclasses.replace(
            c.model, prior=prior))

    Y, _ = make_synthetic(40, 24, 2, seed=1)
    plain = dt.fit(Y, cfg(), device="cpu")
    _timed_sweeps(monkeypatch)
    res = dt.fit(Y, cfg(), device="cpu")
    np.testing.assert_array_equal(res.Sigma, plain.Sigma)
    assert "gig" not in plain.graphs and plain.graphs["stage_ms"] == {}
    stages = res.graphs["stage_ms"]
    base = set(SWEEP) | {"combine", "health_trace", profiling.OTHER}
    if prior != "dl":
        assert set(stages) == base and "gig" not in res.graphs
        return
    assert set(stages) == base | {"gig"}
    assert 0 < stages["gig"] < stages["prior_update"]
    G, P, K = 3, 8, 3
    draws = 2 * 12 * (G * P * K + G * P)
    got = res.graphs["gig"]
    assert set(got) == {"draws", "rounds_evaluated", "rounds_needed",
                        "unaccepted"}
    assert got["draws"] == draws and got["rounds_evaluated"] == 64 * draws
    assert draws <= got["rounds_needed"] <= got["rounds_evaluated"]
    assert got["unaccepted"] >= 0
