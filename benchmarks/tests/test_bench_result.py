"""The run's last line, the entry's refusals, the trace reading and the
metric readers, on the CPU."""

import json
import os
import subprocess
import sys
import time

import pytest

from conftest import ROOT, tiny_cell
from fitbench import cell as runner, spec, trace

BENCH = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))


@pytest.mark.parametrize("name", ["ns_mgp.fit", "c5_hs_adapt.fit"])
@pytest.mark.parametrize("traced", [False, True])
def test_the_result_object(name, traced):
    c = tiny_cell(name)
    out = runner.run_cell(c, 2 ** 31 + 11, 0.5, traced, "cpu",
                          time.perf_counter())
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "compared"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1 + traced
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert set(out["compared"]) == set(c.config["limits"])
    for row in out["compared"].values():
        assert row["value"] <= row["limit"]
    names = {m["name"] for m in (c.per_layer if traced else c.end_to_end)}
    # the CPU has no device trace: only the program's clocks are read
    assert set(out["metrics"]) <= names
    if not traced:
        assert set(out["metrics"]) == names
        assert out["metrics"]["fit_s"]["value"] > 0
    json.dumps(out)


def test_phase_spans_wrap_and_restore():
    from dcfm_tpu_torch import api
    before = {name: getattr(api, name) for name in trace.PHASES}
    with trace.phase_spans(api):
        assert all(getattr(api, n) is not f for n, f in before.items())
        assert api.preprocess.__wrapped__ is before["preprocess"]
    assert all(getattr(api, n) is f for n, f in before.items())


def test_the_entry_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "ns_mgp.fit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, linked=0):
        from torch.autograd import DeviceType
        self._v = (name, DeviceType.CUDA if dev else DeviceType.CPU, start,
                   dur, corr, linked)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def test_trace_summary_by_hand():
    ev = [Ev("fit", 0, 0, 1000), Ev("api.chain", 0, 100, 800),
          Ev("api.assemble", 0, 900, 100),
          Ev("cudaGraphLaunch", 0, 150, 5, corr=7),
          Ev("cudaGraphLaunch", 0, 400, 5, corr=8),
          Ev("k", 1, 200, 100, corr=7), Ev("k", 1, 300, 50, corr=7),
          Ev("k", 1, 500, 100, corr=8),
          Ev("api.chain", 1, 200, 400),     # a host span on the device
          Ev("copy", 1, 950, 10, corr=9)]
    t = trace.summarize(ev)
    assert t.window_s == pytest.approx(1e-6)
    assert t.busy_s == pytest.approx(260e-9)
    assert t.by_name == {"k": (pytest.approx(250e-9), 3),
                         "copy": (pytest.approx(10e-9), 1)}
    assert sorted(t.replays) == [(1, pytest.approx(100e-9)),
                                 (2, pytest.approx(150e-9))]
    # gaps, named by the innermost span open at their middle: [0, 200)
    # (middle 100), [350, 500) and [600, 950) inside api.chain, [960,
    # 1000) inside api.assemble
    assert t.gaps_by_span == {"api.chain": pytest.approx(700e-9),
                              "api.assemble": pytest.approx(40e-9)}
    bd = t.breakdown()
    assert bd["device_ops"][0][0] == "k" and bd["idle_gaps"][0][0] == \
        "api.chain"


def test_readers_on_a_made_up_fit():
    rec = runner.FitRecord(
        seconds=2.0, phase={"preprocess_s": 0.1, "upload_s": 0.05,
                            "init_s": 0.05, "chain_s": 1.0,
                            "exposed_fetch_s": 0.2, "assemble_s": 0.3},
        graphs={"capture_s": 0.04, "unroll": 1}, launches={}, sweeps=100,
        chains=2, saved=10)
    t = trace.Trace(window_s=2.0, busy_s=1.5,
                    by_name={"void chol_group_kernel<8, 256, false, true, "
                             "true>(float const*)": (1e-5, 10),
                             "void sse_ps_fixed<8, true, 256>(x)": (2e-5, 10),
                             "void chol_group_kernel<8, 256, true, true, "
                             "true>(float const*)": (9.0, 10)},
                    replays=[(10, 1e-3)] * 8 + [(11, 1e-3), (20, 3e-3),
                                                (21, 3e-3)],
                    gaps_by_span={})
    shape = {"G": 64, "n": 500, "P": 157, "K": 8}
    ctx = runner.Context(shape=shape, fits=[rec, rec], traced=rec, trace=t)

    def read(name):
        return spec.metric_reader(name).read(ctx)
    assert read("api.preprocess_s") == pytest.approx(0.2)
    assert read("api.tail_s") == pytest.approx(0.5)
    assert read("chain.sweeps_per_s") == pytest.approx(200.0)
    assert read("chain.capture_s") == pytest.approx(0.04)
    # busy 1.5 s of the unprofiled fits' 2.0 s
    assert read("device.idle_pct") == pytest.approx(25.0)
    assert read("sweep.device_ms") == pytest.approx(15e-3 / 11 * 1e3)
    # K1 is the DIV_BWD = false instance: 1 us a launch
    k1 = spec.counts("chol_sample").nbytes(shape) / 3.35e12
    assert read("chol_sample_roofline") == pytest.approx(100 * k1 / 1e-6)
    k5 = spec.counts("sse_ps").nbytes(shape) / 3.35e12
    assert read("sse_ps_roofline") == pytest.approx(100 * k5 / 2e-6)
    comb = spec.counts("combine").nbytes(shape) / 3.35e12
    assert read("combine_roofline") == pytest.approx(100 * comb / 2e-3)
    flops = 2 * (100 * spec.counts("sweep").flops(shape)
                 + 10 * spec.counts("combine").flops(shape))
    assert read("mfu.sweep") == pytest.approx(100 * flops / 67e12)
    ctx.trace = None
    assert read("combine_roofline") is None and read("device.idle_pct") \
        is None
