"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program.  Top-level module names
are compared whole: the program's name, dcfm_tpu_torch, begins with the
JAX package's."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from fitbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dcfm_tpu"}
FILES = sorted(glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True))


def top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, BENCH) for f in FILES])
def test_no_source_imports_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


def _named_references() -> set:
    """Every file a configuration in BENCHMARK.json names as its plain
    reference."""
    bench = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    return {os.path.normpath(os.path.join(
        ROOT, spec.load_json(os.path.join(ROOT, c["file"]))["reference"]))
        for c in bench["configs"]}


def test_the_reference_imports_nothing_of_the_program():
    named = _named_references()
    assert named and all(os.path.isfile(p) for p in named)
    for path in named | set(glob.glob(os.path.join(BENCH, "fitref",
                                                   "*.py"))):
        assert top_level_imports(path) <= {
            "__future__", "dataclasses", "math", "numpy", "torch",
            "fitref"}, path


def test_nothing_loaded_is_jax():
    """The harness, the reference and the program, imported and run for a
    tiny fit in a fresh interpreter: no loaded module's top-level name is
    JAX's or the JAX package's."""
    code = (
        "import sys; sys.path[:0] = [%r, %r, %r]\n"
        "import numpy as np\n"
        "from fitbench import cell, check, data, spec, trace\n"
        "from conftest import tiny_cell\n"
        "c = tiny_cell('ns_mgp.fit')\n"
        "import dcfm_tpu_torch\n"
        "Y = data.make_data(c.config['data'], 1, 'cpu')\n"
        "cfg = cell.fit_config(c.config, c.traffic, 3)\n"
        "dcfm_tpu_torch.fit(Y, cfg, device='cpu')\n"
        "check.reference(Y, c.config, c.traffic, 3, 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        % (ROOT, BENCH, os.path.join(BENCH, "tests")))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "dcfm_tpu_torch" in loaded and "fitref" in loaded
    assert not loaded & FORBIDDEN


def test_the_run_refuses_a_process_that_loaded_jax(monkeypatch):
    """The run checks its own process once the window has closed: a
    module named ``dcfm_tpu`` (or ``jax``, ``jaxlib``, ``flax``) there
    ends it without a result, while ``dcfm_tpu_torch`` is the program."""
    import time
    import types

    from conftest import tiny_cell
    from fitbench import cell as runner

    import dcfm_tpu_torch  # noqa: F401
    assert runner.jax_modules() == []
    monkeypatch.setitem(sys.modules, "dcfm_tpu.api",
                        types.ModuleType("dcfm_tpu.api"))
    assert runner.jax_modules() == ["dcfm_tpu"]
    with pytest.raises(runner.JaxLoaded, match="dcfm_tpu"):
        runner.run_cell(tiny_cell("ns_mgp.fit"), 7, 0.1, False, "cpu",
                        time.perf_counter())
