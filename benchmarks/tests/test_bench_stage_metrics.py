"""The readers of the program's stage timers and of the chain's idle gaps
(sweep.*_ms, combine.device_ms, chain.idle_ms) on a made-up traced fit."""

import pytest

from fitbench import cell as runner, spec, trace

STAGES = {"sweep.z_ms": "z_update", "sweep.x_ms": "x_update",
          "sweep.lambda_ms": "lambda_update",
          "sweep.prior_ms": "prior_update", "sweep.ps_ms": "ps_update",
          "sweep.health_ms": "health_trace",
          "combine.device_ms": "combine"}
STAGE_MS = {"z_update": 0.11, "x_update": 0.07, "lambda_update": 0.2,
            "prior_update": 0.09, "ps_update": 0.05, "health_trace": 0.03,
            "combine": 7.5, "adapt_rank": 0.02, "other": 0.01}


def _ctx(stage_ms, gaps, *, traced=True):
    rec = runner.FitRecord(
        seconds=2.0, phase={"chain_s": 1.0},
        graphs={"unroll": 1, "stage_ms": stage_ms,
                "stage_samples": 4 if stage_ms else 0},
        launches={}, sweeps=1000, chains=2, saved=100)
    t = trace.Trace(window_s=2.0, busy_s=1.0, by_name={}, replays=[],
                    gaps_by_span=gaps)
    return runner.Context(shape={"G": 64, "n": 500, "P": 157, "K": 8},
                          fits=[rec], traced=rec if traced else None,
                          trace=t if traced else None)


def read(name, ctx):
    return spec.metric_reader(name).read(ctx)


@pytest.mark.parametrize("name", sorted(STAGES))
def test_a_stage_reader_reads_its_stage(name):
    assert read(name, _ctx(dict(STAGE_MS), {})) == STAGE_MS[STAGES[name]]


@pytest.mark.parametrize("name", sorted(STAGES))
def test_a_stage_reader_reads_nothing_where_nothing_was_timed(name):
    assert read(name, _ctx({}, {})) is None
    assert read(name, _ctx(dict(STAGE_MS), {}, traced=False)) is None
    # a program that times no stage has no such key (the parent's)
    ctx = _ctx({}, {})
    del ctx.traced.graphs["stage_ms"]
    assert read(name, ctx) is None


def test_the_chain_idle_sums_the_loop_and_its_steps_only():
    gaps = {"fit": 0.5, "api.init": 0.3, "api.chain": 0.2,
            "api.chain.draw": 0.6, "api.chain.replay.plain": 0.1,
            "api.chain.boundary": 0.05, "api.chainz": 9.0,
            "api.assemble": 0.4}
    got = read("chain.idle_ms", _ctx({}, gaps))
    # (0.2 + 0.6 + 0.1 + 0.05) s over 1,000 sweeps of 2 chains
    assert got == pytest.approx(1e3 * 0.95 / 2000)
    assert read("chain.idle_ms", _ctx({}, {"api.init": 1.0})) == 0.0
    assert read("chain.idle_ms", _ctx({}, gaps, traced=False)) is None


def test_every_new_metric_is_in_the_benchmark():
    bench = spec.load_json(spec.ROOT + "/BENCHMARK.json")
    entries = {m["name"]: m for m in bench["per_layer"]}
    cells = [w["name"] for w in bench["workloads"]]
    for name in list(STAGES) + ["chain.idle_ms"]:
        m = entries[name]
        assert m["workloads"] == cells and m["moves"] == "fit_s"
        assert m["unit"] == "ms" and m["better"] == "lower"
        assert m["source"] == ("device_trace" if name == "chain.idle_ms"
                               else "program_span")
