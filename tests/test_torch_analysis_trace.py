"""The port's trace gate (``dcfm_tpu_torch/analysis/tracecheck.py``) on
the CPU.

Every registered entry - the nine names of the JAX package's
``registry.discover()`` - runs once under the recorder and verifies
clean.  Each seeded hazard, registered under a ``fixture.`` prefix from a
module written into ``tmp_path``, fires exactly its rule, DCFM1800 to
DCFM1809, and ``discover()`` leaves the fixtures out.

The oracle of the trace rules is their stated meaning
(``analysis/rules.TRACE_RULES``), not a run of the JAX gate: the JAX
package's own ``tests/test_tracecheck.py`` fails to import under jax 0.9
(``from jax.core import ClosedJaxpr``), and its rules read jaxprs, which
the port does not have.  What is held against the JAX package is the
registry's shape: the same nine entry names.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.analysis import registry as jax_registry  # noqa: E402
from dcfm_tpu_torch.analysis import __main__ as port_main  # noqa: E402
from dcfm_tpu_torch.analysis import registry, tracecheck  # noqa: E402
from dcfm_tpu_torch.analysis.baseline import (  # noqa: E402
    apply_baseline, build_baseline)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["models.gibbs_sweep[bf16]", "models.gibbs_sweep[f32]",
         "models.gibbs_sweep[gram-bf16]", "models.gibbs_sweep[gram-f32]",
         "models.run_chunk", "parallel.mesh_chunk", "parallel.packed_chunk",
         "parallel.pod_chunk", "runtime.fetch_quant8"]


def test_the_entries_are_the_jax_registry_s():
    assert [e.name for e in registry.discover()] == NAMES
    assert [e.name for e in jax_registry.discover()] == NAMES


@pytest.mark.parametrize("name", NAMES)
def test_every_entry_runs_clean(name):
    """Each entry ran (ops recorded), in its registered module, and gave
    no finding; the sweep bodies are flagged so; the mesh entries
    issued the sweep's collectives through the stand-ins."""
    entry = {e.name: e for e in registry.discover()}[name]
    res = tracecheck.trace_entry(entry, "cpu")
    assert res.findings == [] and res.skipped is None
    assert res.ops > 10
    assert entry.sweep_body == (name != "runtime.fetch_quant8")
    assert entry.path.startswith(os.path.join(REPO, "dcfm_tpu_torch"))
    # 3 all-reduces a sweep (the X update's two sums, the trace), 3
    # all-gathers a saved draw: 2 sweeps, one saved
    assert res.collectives == (
        {"all_reduce": 6, "all_gather_into_tensor": 3}
        if name.startswith("parallel.") else {})


def test_the_gate_exits_0_with_every_entry_traced():
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.analysis", "--trace",
         "--device", "cpu", "--fail-on", "warning"],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert cp.returncode == 0, cp.stdout + cp.stderr
    assert cp.stdout.strip() == "dcfm-lint: clean"
    traced = [line for line in cp.stderr.splitlines()
              if line.startswith("dcfm-lint: trace ")]
    assert [line.split()[2][:-1] for line in traced] == NAMES
    assert all(" ops in " in line and "0 finding(s)" in line
               for line in traced)


def test_without_a_card_the_gate_needs_device_cpu(monkeypatch, capsys):
    """--trace defaults to the card; with none it exits 2 and says so,
    and never traces on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_main.main(["--trace"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def test_the_cache_answers_for_unchanged_modules(tmp_path):
    """A second run with the same cache file traces nothing and gives the
    same (empty) findings."""
    cache = str(tmp_path / "trace.json")
    seen = []
    for _ in range(2):
        assert tracecheck.check_project(
            cache_path=cache, device="cpu",
            report=lambda name, res: seen.append(res is None)) == []
    assert seen == [False] * 9 + [True] * 9


_FIXTURES = textwrap.dedent('''\
    """Seeded trace hazards: one entry per DCFM18xx rule."""
    import torch
    import torch.distributed as dist

    from dcfm_tpu_torch.analysis.registry import (
        TraceSpec, register_trace_entry)
    from dcfm_tpu_torch.config import ModelConfig
    from dcfm_tpu_torch.models.sampler import (
        carry_tensors, save_pattern, trace_runner, trace_trip)
    from dcfm_tpu_torch.parallel.mesh import make_layout, make_pod_layout
    from dcfm_tpu_torch.parallel.shard import RankMesh


    class WrongGroupMesh(RankMesh):
        """The mesh's seam summing over ``group(self)``."""

        def __init__(self, layout, device, group, pod=False):
            super().__init__(layout, device, pod=pod)
            self.wrong = group(self)

        def reduce_fn(self, x):
            s = torch.sum(x, dim=0)
            dist.all_reduce(s, group=self.wrong)
            return s


    def mesh_trip(device, layout, group, pod=False):
        cfg = ModelConfig(num_shards=layout.num_shards,
                          factors_per_shard=3, rho=0.8)
        mesh = WrongGroupMesh(layout, torch.device(device), group, pod=pod)
        runner = trace_runner(device, cfg, layout.local_shards, mesh=mesh)
        return TraceSpec(fn=trace_trip(runner, layout.chains[0]),
                         device=device, mesh=layout, pod=pod,
                         carry=lambda: carry_tensors(runner.carry))


    @register_trace_entry("fixture.builder_raises", sweep_body=True)
    def builder_raises(device):                                # DCFM1800
        raise ValueError("no representative input")


    @register_trace_entry("fixture.foreign_group", sweep_body=True)
    def foreign_group(device):                                 # DCFM1801
        # the other rank alone: not the chain row's group
        return mesh_trip(device, make_layout(2, 0, 4, 1),
                         lambda m: dist.new_group([1]))


    @register_trace_entry("fixture.column_group", sweep_body=True)
    def column_group(device):                                  # DCFM1802
        # a packed 2 x 2 layout summing over its column: across chains
        return mesh_trip(device, make_layout(4, 0, 4, 2),
                         lambda m: m._col)


    @register_trace_entry("fixture.float64", sweep_body=True)
    def float64(device):                                       # DCFM1803
        x = torch.ones(4, device=device)
        return TraceSpec(fn=lambda: (x.double() * 2).float(),
                         device=device)


    @register_trace_entry("fixture.bf16_output")
    def bf16_output(device):                                   # DCFM1804
        a = torch.ones((4, 4), device=device)
        return TraceSpec(fn=lambda: a.bfloat16() @ a.bfloat16(),
                         device=device, compute_dtype="bf16")


    @register_trace_entry("fixture.item", sweep_body=True)
    def item(device):                                          # DCFM1805
        x = torch.ones(4, device=device)
        return TraceSpec(fn=lambda: x.sum().item(), device=device)


    @register_trace_entry("fixture.rebound_carry", sweep_body=True)
    def rebound_carry(device):                                 # DCFM1806
        box = {"state": torch.zeros(3, device=device)}

        def step():
            box["state"] = box["state"] + 1
        return TraceSpec(fn=step, device=device,
                         carry=lambda: [box["state"]])


    @register_trace_entry("fixture.list_key")
    def list_key(device):                                      # DCFM1807
        return TraceSpec(fn=lambda: None, device=device,
                         static_key=([3, 8],))


    @register_trace_entry("fixture.host_group", sweep_body=True)
    def host_group(device):                                    # DCFM1808
        # a 2-host pod summing over this host's part of the row
        return mesh_trip(device, make_pod_layout(2, 0, 4, 1),
                         lambda m: dist.new_group([0]), pod=True)


    @register_trace_entry("fixture.live_draws", sweep_body=True)
    def live_draws(device):                                    # DCFM1809
        # the second trip on live TorchNoise streams, as if nothing had
        # been drawn ahead: torch.randn (and the Gammas) inside the trip
        cfg = ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8)
        runner = trace_runner(device, cfg, 2)
        trace_trip(runner)
        pattern = save_pattern(2, 2, runner.burnin, runner.thin)
        live = [runner.noise.sweep(0, 2 + j) for j in range(2)]
        return TraceSpec(fn=lambda: runner._sweeps(live, pattern),
                         device=device,
                         carry=lambda: carry_tensors(runner.carry))
''')

FIXTURE_RULES = {
    "fixture.builder_raises": "DCFM1800",
    "fixture.foreign_group": "DCFM1801",
    "fixture.column_group": "DCFM1802",
    "fixture.float64": "DCFM1803",
    "fixture.bf16_output": "DCFM1804",
    "fixture.item": "DCFM1805",
    "fixture.rebound_carry": "DCFM1806",
    "fixture.list_key": "DCFM1807",
    "fixture.host_group": "DCFM1808",
    "fixture.live_draws": "DCFM1809",
}


@pytest.fixture(scope="module")
def hazards(tmp_path_factory):
    """The fixture module, imported from a temporary directory (its
    entries registered), and its path; unregistered after the tests."""
    path = tmp_path_factory.mktemp("trace_fixtures") / "trace_hazards.py"
    path.write_text(_FIXTURES)
    spec = importlib.util.spec_from_file_location("trace_hazards", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    yield str(path)
    for name in FIXTURE_RULES:
        registry._REGISTRY.pop(name, None)


@pytest.mark.parametrize("name,rule", sorted(FIXTURE_RULES.items()))
def test_each_seeded_hazard_fires_exactly_its_rule(hazards, name, rule):
    """Anchored at the registration line in the fixture module, with the
    entry's name in the message."""
    entry = registry.get(name)
    findings = tracecheck.check_entry(entry, device="cpu")
    assert {f.rule for f in findings} == {rule}, findings
    lines = open(hazards).read().splitlines()
    for f in findings:
        assert (f.path, f.col) == (hazards, 0)
        assert lines[f.line - 1].startswith(
            f'@register_trace_entry("{name}"'), lines[f.line - 1]
        assert f.message.startswith(f"[{name}] ")


def test_discover_leaves_the_fixtures_out(hazards):
    assert set(FIXTURE_RULES) <= set(registry.entries())
    assert [e.name for e in registry.discover()] == NAMES
    assert set(FIXTURE_RULES) <= {
        e.name for e in registry.discover(library_only=False)}


def test_trace_findings_baseline_like_ast_findings(hazards, tmp_path):
    """A trace finding fingerprints at its registration line, so the
    shared baseline suppresses it as it does an AST finding."""
    findings = tracecheck.check_entries(
        [registry.get("fixture.float64"), registry.get("fixture.item")])
    assert [f.rule for f in findings] == ["DCFM1803", "DCFM1805"]
    base = build_baseline(findings, str(tmp_path))
    new, suppressed, stale = apply_baseline(findings, base, str(tmp_path))
    assert (new, len(suppressed), stale) == ([], 2, [])


def test_importing_the_registry_imports_no_torch():
    """registry.py, loaded alone with torch refused: inert until a
    builder runs."""
    code = textwrap.dedent(f"""\
        import importlib.util, sys
        sys.modules["torch"] = None
        spec = importlib.util.spec_from_file_location(
            "reg", {os.path.join(REPO, "dcfm_tpu_torch", "analysis",
                                 "registry.py")!r})
        reg = sys.modules["reg"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(reg)
        reg.register_trace_entry("x")(lambda device: None)
        print(sorted(reg.entries()))
    """)
    cp = subprocess.run([sys.executable, "-c", code], capture_output=True,
                        text=True, timeout=60)
    assert cp.returncode == 0, cp.stderr
    assert cp.stdout.strip() == "['x']"


def test_the_recorder_reads_no_value():
    """The recorder notes names, dtypes, devices and shapes only: a
    recorded sweep dispatches no _local_scalar_dense of its own, and the
    stand-in collectives' copies stay off the record."""
    x = torch.arange(6.0).reshape(2, 3)
    out = torch.empty(4, 3)
    with tracecheck.fake_collectives() as log, \
            tracecheck.record() as rec:
        y = x * 2
        import torch.distributed as dist
        dist.all_gather_into_tensor(out, y)
    assert [op.packet for op in rec.ops] == ["mul"]
    assert rec.ops[0].ins == (("torch.float32", "cpu", (2, 3)),)
    assert rec.ops[0].outs == (("torch.float32", "cpu", (2, 3)),)
    assert log == [("all_gather_into_tensor", None)]
    torch.testing.assert_close(out, torch.cat([y, y]))
