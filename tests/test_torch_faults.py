"""The port's fault plan against the JAX package's.

``dcfm_tpu_torch.resilience.faults`` is a copy: the same specs are
accepted and refused (with the same error class and message), the four
seeded spec streams are equal, and the write seams the serving plane
carries fire the same way.  The port's fit has no fault seams yet, so a
plan that could only fire inside a fit is refused at its start, naming
ROADMAP Queue A item 7.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.resilience import faults as jf  # noqa: E402
from dcfm_tpu_torch.resilience import faults as tf  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402


@pytest.fixture(autouse=True)
def _no_plans():
    jf.clear()
    tf.clear()
    yield
    jf.clear()
    tf.clear()


SPECS = [
    {"faults": []},
    {"faults": [{"op": "kill", "at_iteration": 4, "when": "pre_save"}]},
    {"faults": [{"op": "io_delay", "target": "panel", "at_write": 2,
                 "seconds": 0.01, "process": 1}]},
    {"faults": [{"op": "bit_flip", "target": "artifact", "at_write": 1}]},
    {"faults": [{"op": "kill_event", "event": "serve_request",
                 "at_occurrence": 3, "at_launch": 1}]},
    {"faults": [{"op": "bogus"}]},
    {"faults": [{"op": "kill"}]},
    {"faults": [{"op": "poison_state"}]},
    {"faults": [{"op": "kill_event"}]},
    {"faults": [{"op": "torn_write", "target": "delta"}]},
    {"nope": []},
    {"faults": {"op": "kill"}},
]


@pytest.mark.parametrize("spec", SPECS)
def test_plans_accept_and_refuse_as_in_the_jax_package(spec):
    def outcome(mod):
        try:
            plan = mod.FaultPlan(spec)
        except mod.FaultPlanError as e:
            return ("refused", str(e))
        return ("ok", plan.faults)

    assert outcome(tf) == outcome(jf)


def test_env_plans_and_fuzz_variable_parse_the_same(monkeypatch, tmp_path):
    plan = {"faults": [{"op": "io_error", "target": "pointer",
                        "at_write": 1}]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(plan))
    for raw in (json.dumps(plan), f"@{path}"):
        monkeypatch.setenv("DCFM_FAULT_PLAN", raw)
        assert tf.FaultPlan.from_env().faults == jf.FaultPlan.from_env().faults
    monkeypatch.setenv("DCFM_FAULT_PLAN", "{not json")
    for mod in (tf, jf):
        with pytest.raises(mod.FaultPlanError, match="not valid JSON"):
            mod.FaultPlan.from_env()
    monkeypatch.delenv("DCFM_FAULT_PLAN")
    for fuzz in ("7:3", "7:3:elastic", "7:3:pod", "-2:11"):
        monkeypatch.setenv("DCFM_FAULT_FUZZ", fuzz)
        assert tf.FaultPlan.from_env().faults == jf.FaultPlan.from_env().faults
    monkeypatch.setenv("DCFM_FAULT_FUZZ", "7")
    for mod in (tf, jf):
        with pytest.raises(mod.FaultPlanError, match="seed:index"):
            mod.FaultPlan.from_env()


@pytest.mark.parametrize("seed", [0, 1, 20260804])
def test_the_four_spec_streams_are_the_jax_packages(seed):
    for i in range(12):
        assert tf.fuzz_spec(seed, i) == jf.fuzz_spec(seed, i)
        assert tf.fuzz_spec(seed, i, events=()) == \
            jf.fuzz_spec(seed, i, events=())
        assert tf.elastic_fuzz_spec(seed, i) == jf.elastic_fuzz_spec(seed, i)
        assert tf.pod_fuzz_spec(seed, i) == jf.pod_fuzz_spec(seed, i)
        assert tf.serve_fuzz_spec(seed, i) == jf.serve_fuzz_spec(seed, i)
        assert tf.serve_fuzz_spec(seed, i, workers=3, max_requests=9) == \
            jf.serve_fuzz_spec(seed, i, workers=3, max_requests=9)


def test_write_seams_and_gates_fire_the_same(monkeypatch, tmp_path):
    """on_write / mutate_payload / after_replace / kill_event counting and
    the process and launch gates, driven identically on both plans."""
    spec = {"faults": [
        {"op": "io_error", "target": "panel", "at_write": 2, "process": 0},
        {"op": "bit_flip", "target": "artifact", "at_write": 1},
        {"op": "torn_write", "target": "artifact", "at_write": 2,
         "keep_fraction": 0.25},
        {"op": "io_delay", "target": "delta", "at_write": 1,
         "seconds": 0.0, "at_launch": 2}]}
    monkeypatch.setenv("DCFM_FAULT_PROCESS", "0")
    monkeypatch.setenv("DCFM_FAULT_LAUNCH", "1")
    results = []
    for mod in (tf, jf):
        plan = mod.install(spec)
        out = [plan.on_write("panel", "mean:0")]
        with pytest.raises(OSError, match="injected I/O failure"):
            plan.on_write("panel", "mean:1")
        c = plan.on_write("artifact", "a")
        payload = {"x": np.arange(6, dtype=np.int8)}
        out.append(plan.mutate_payload("artifact", "a", c, payload)["x"]
                   .tolist())
        f = tmp_path / f"{mod.__name__}.bin"
        f.write_bytes(b"\x01" * 100)
        c2 = plan.on_write("artifact", "a")
        plan.after_replace("artifact", str(f), c2)
        out += [c, c2, os.path.getsize(f), plan.on_write("delta", "d")]
        results.append(out)
    assert results[0] == results[1]
    assert results[0][1][0] == 1 and results[0][4] == 25


def test_fit_refuses_a_plan_with_fit_side_faults():
    """A plan whose faults could only fire inside a fit is refused at the
    fit's start, naming ROADMAP Queue A item 7; a serve-side plan is not."""
    import dcfm_tpu_torch as dt
    from tests.test_torch_fit import _names_a_queue_a_item

    Y, _ = make_synthetic(24, 8, 2, seed=0)
    cfg = dt.FitConfig(model=dt.ModelConfig(num_shards=2,
                                            factors_per_shard=2, rho=0.5),
                       run=dt.RunConfig(burnin=2, mcmc=2))
    fit_side = [
        {"op": "kill", "at_iteration": 2},
        {"op": "poison_state", "at_iteration": 2},
        {"op": "torn_write", "at_write": 1},        # target: checkpoint
        {"op": "io_error", "target": "checkpoint", "at_write": 1},
        {"op": "kill_event", "event": "resume_gate"},
        {"op": "kill_event", "event": "stream_submit"},
    ]
    for f in fit_side:
        tf.install({"faults": [f]})
        with pytest.raises(NotImplementedError) as e:
            dt.fit(Y, cfg, device="cpu")
        assert _names_a_queue_a_item(str(e.value)), str(e.value)
        assert tf.fit_faults(tf.fault_plan()) == [f]
    serve_side = {"faults": [
        {"op": "io_delay", "target": "panel", "at_write": 1, "seconds": 0},
        {"op": "kill_event", "event": "swap_commit"},
        {"op": "kill_event", "event": "delta_materialize"},
        {"op": "torn_write", "target": "pointer", "at_write": 1},
        {"op": "bit_flip", "target": "delta", "at_write": 1}]}
    tf.install(serve_side)
    assert tf.fit_faults(tf.fault_plan()) == []
    res = dt.fit(Y, cfg, device="cpu")
    assert np.isfinite(res.Sigma).all()


def test_artifact_seam_flips_after_the_crcs_in_both_packages(tmp_path):
    """bit_flip on an artifact write lands after the CRCs: both packages
    write the same (corrupt) bytes and meta, and the port's engine refuses
    the flipped panel on first touch."""
    from dcfm_tpu.serve.artifact import write_artifact as jwrite
    from dcfm_tpu.utils.preprocess import preprocess as jpre
    from dcfm_tpu_torch.serve.artifact import (
        ArtifactCorruptError, write_artifact)
    from dcfm_tpu_torch.serve.engine import QueryEngine
    from dcfm_tpu_torch.utils.preprocess import preprocess

    rng = np.random.default_rng(0)
    Y = rng.standard_normal((20, 12)).astype(np.float32)
    q = rng.integers(-127, 128, size=(3, 6, 6)).astype(np.int8)
    s = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    spec = {"faults": [{"op": "bit_flip", "target": "artifact",
                        "at_write": 1}]}
    tf.install(spec)
    jf.install(spec)
    a = write_artifact(str(tmp_path / "t"), mean_q8=q, mean_scale=s,
                       pre=preprocess(Y, 2))
    jwrite(str(tmp_path / "j"), mean_q8=q, mean_scale=s, pre=jpre(Y, 2))
    for name in ("mean_q8.bin", "meta.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()
    with pytest.raises(ArtifactCorruptError):
        QueryEngine(a, device="cpu").entry(int(a.pre.kept_cols[
            a.pre.perm[0]]), int(a.pre.kept_cols[a.pre.perm[0]]))
