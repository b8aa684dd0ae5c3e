"""The port's translated AST rules: the fifteen ids whose JAX detectors
matched JAX names now match the torch spelling of their hazard.

Each rule gets a firing and a clean source in port idiom, written under
``tmp_path`` as modules of a small package (with ``runtime/``,
``parallel/`` and ``models/`` subpackages, so the library-only and module
scopes apply) and linted by ``python -m dcfm_tpu_torch.analysis``'s
``main``.  A firing source marks each line that must be reported with a
trailing ``# <-`` comment; the rule must report exactly those lines and
nothing else may fire, and the clean source must lint clean.  The
sources stay strings here: a file under tests/fixtures/ would be linted
by the JAX whole-tree gate, which excludes only tests/fixtures/lint.
"""

import contextlib
import io
import json
import os
import textwrap

import pytest

from dcfm_tpu.analysis import linter as jax_linter
from dcfm_tpu_torch.analysis import __main__ as port_main
from dcfm_tpu_torch.analysis import linter as port_linter
from dcfm_tpu_torch.analysis import rules as port_rules

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "lint")


def _src(text: str) -> str:
    return textwrap.dedent(text).lstrip("\n")


# rule -> (firing files, clean files); each a {path in the package: source}
CASES = {
    "DCFM101": ({"models/draws.py": _src("""
        import torch


        def noise(shape, gen, a, b, out):
            x = torch.randn(shape, generator=gen)
            y = torch.randn(shape)  # <-
            out.exponential_()  # <-
            z = torch.distributions.Gamma(a, b).sample()  # <-
            w = torch.rand(shape, generator=None)  # <-
            return x + y + z + w


        def streams(seed):
            g1, g2 = torch.Generator(), torch.Generator()
            g1.manual_seed(seed)
            g2.manual_seed(seed)  # <-
            return g1, g2
    """)}, {"models/draws.py": _src("""
        import torch


        def noise(shape, gen, out):
            out.exponential_(generator=gen)
            return torch.randn(shape, generator=gen) + out


        def streams(seed, n, restart):
            gens = []
            for i in range(n):
                g = torch.Generator()
                g.manual_seed(seed + i)
                gens.append(g)
            h = torch.Generator()
            if restart:
                h.manual_seed(seed)
            else:
                h.manual_seed(seed)
            return gens, h
    """)}),
    "DCFM102": ({"noise.py": _src("""
        import torch


        def default_streams(device):
            torch.manual_seed(0)  # <-
            return torch.Generator(device=device).manual_seed(1234)  # <-
    """)}, {"noise.py": _src("""
        import torch


        def default_streams(device, seed):
            torch.manual_seed(seed)
            return torch.Generator(device=device).manual_seed(seed + 1)
    """)}),
    # a capture in one module reaches a host sync in another
    "DCFM201": ({"models/trip.py": _src("""
        import numpy as np
        import torch

        from pkg.ops.health import peak


        class Runner:
            def capture(self, graph, x):
                with torch.cuda.graph(graph):
                    self._trip(x)

            def _trip(self, x: torch.Tensor):
                y = x * 2
                h = peak(y)
                idx = torch.nonzero(y > 0)  # <-
                torch.cuda.synchronize()  # <-
                return float(y.sum()), np.asarray(y), h, idx  # <-
    """), "ops/health.py": _src("""
        import torch


        def peak(y: torch.Tensor):
            return y.abs().max().item()  # <-
    """)}, {"models/trip.py": _src("""
        import torch

        from pkg.ops.health import peak


        class Runner:
            def capture(self, graph, x):
                with torch.cuda.graph(graph):
                    self._trip(x)
                return peak(x)

            def _trip(self, x: torch.Tensor):
                n = int(x.shape[0]) + x.numel()
                return x * n
    """), "ops/health.py": _src("""
        import torch


        def peak(y: torch.Tensor):
            return y.abs().max().item()
    """)}),
    "DCFM202": ({"models/step.py": _src("""
        import torch


        def step(x: torch.Tensor) -> torch.Tensor:
            s = x.sum()
            if s > 0:  # <-
                x = x - s
            while torch.any(x > 1):  # <-
                x = x / 2
            return x


        graphed = torch.cuda.make_graphed_callables(step, (torch.zeros(4),))
    """)}, {"models/step.py": _src("""
        import torch


        def step(x: torch.Tensor, mask=None) -> torch.Tensor:
            if mask is not None:
                x = x * mask
            if x.shape[0] > 1 and x.dtype == torch.float32:
                x = x[1:]
            return torch.where(x > 0, x, -x)


        graphed = torch.cuda.make_graphed_callables(step, (torch.zeros(4),))
    """)}),
    # a sweep-body builder's entry (its TraceSpec fn) is captured code;
    # the builder's own set-up runs eagerly
    "DCFM203": ({"models/entry.py": _src("""
        import os

        import torch

        from dcfm_tpu_torch.analysis.registry import (
            TraceSpec, register_trace_entry)


        def _scale():
            return float(os.environ.get("DCFM_SCALE", "1"))  # <-


        @register_trace_entry("pkg.sweep", sweep_body=True)
        def _trace_sweep(device):
            x = torch.ones(4, device=device)

            def sweep():
                return x * _scale()
            return TraceSpec(fn=sweep, device=device)
    """)}, {"models/entry.py": _src("""
        import os

        import torch

        from dcfm_tpu_torch.analysis.registry import (
            TraceSpec, register_trace_entry)


        @register_trace_entry("pkg.sweep", sweep_body=True)
        def _trace_sweep(device):
            scale = float(os.environ.get("DCFM_SCALE", "1"))
            x = torch.ones(4, device=device)
            return TraceSpec(fn=lambda: x * scale, device=device)
    """)}),
    "DCFM301": ({"models/acc.py": _src("""
        import numpy as np
        import torch


        def widen(x):
            return x.double()  # <-


        def acc(n, device):
            return torch.zeros(n, dtype=torch.float64, device=device)  # <-


        def from_host(a):
            return torch.as_tensor(a, dtype=np.float64)  # <-
    """)}, {"models/acc.py": _src("""
        import numpy as np
        import torch


        def narrow(x):
            if x.dtype == torch.float64:
                raise TypeError("x must be float32")
            return x.float()


        def host_sums(n):
            return np.zeros(n, np.float64)
    """)}),
    "DCFM302": ({"models/acc.py": _src("""
        import torch


        def acc(n, x):
            return torch.zeros(n, dtype=float), x.to(float)  # <-
    """)}, {"models/acc.py": _src("""
        import numpy as np
        import torch


        def acc(n, x):
            host = np.zeros(n, dtype=float)
            return torch.zeros(n, dtype=torch.float32), x.to(torch.float32), host
    """)}),
    "DCFM701": ({"parallel/publish.py": _src("""
        import torch.distributed as dist


        def publish(t, rank):
            if rank == 0:
                dist.broadcast(t, src=0)  # <-
            return t


        def finish(mesh, t):
            if dist.get_rank() != 0:
                return None
            return mesh.gather_traces(t)  # <-
    """)}, {"parallel/publish.py": _src("""
        import torch.distributed as dist


        def publish(t, rank):
            if rank == 0:
                dist.gather(t, [t, t], dst=0)
            else:
                dist.gather(t, None, dst=0)
            return t


        def finish(t, rank):
            if rank != 0:
                dist.gather(t, None, dst=0)
                return None
            parts = [t, t]
            dist.gather(t, parts, dst=0)
            return parts


        def total(t, rank):
            dist.all_reduce(t)
            if rank == 0:
                t = t / 2
            return t
    """)}),
    "DCFM801": ({"runtime/boundary.py": _src("""
        import numpy as np
        import torch


        def boundary(trace, acc):
            rows = trace.cpu()  # <-
            torch.cuda.synchronize()  # <-
            return rows, np.asarray(acc)  # <-
    """)}, {"runtime/boundary.py": _src("""
        def boundary(trace, host, stream, ev):
            host.copy_(trace, non_blocking=True)
            ev.record(stream)
            return host.numpy()


        def drain(ev, host):
            ev.synchronize()
            return host.numpy()
    """), "models/rows.py": _src("""
        def rows(trace):
            return trace.cpu().numpy()
    """)}),
    "DCFM1201": ({"utils/load.py": _src("""
        import numpy as np
        import torch


        def upload(path, device):
            a = np.load(path, mmap_mode="r")
            t = torch.from_numpy(a)
            return t.to(device, non_blocking=True)  # <-


        def leaves(path):
            with np.load(path) as z:
                return torch.from_numpy(z["a"])  # <-


        def stage(path, dst):
            src = torch.as_tensor(np.memmap(path, dtype=np.float32, mode="r"))
            dst.copy_(src, non_blocking=True)  # <-
    """)}, {"utils/load.py": _src("""
        import numpy as np
        import torch


        def upload(path, device):
            a = np.load(path, mmap_mode="r")
            t = torch.from_numpy(a).clone()
            return t.to(device, non_blocking=True)


        def leaves(path):
            with np.load(path) as z:
                return torch.from_numpy(np.array(z["a"]))


        def stage(path, dst):
            src = torch.as_tensor(np.memmap(path, dtype=np.float32, mode="r"))
            dst.copy_(src)
    """)}),
    "DCFM1401": ({"utils/pool.py": _src("""
        import torch


        def summaries(chain_means, chain_draws, chain_x):
            a = chain_means.mean(dim=0)  # <-
            b = torch.mean(chain_draws, 0)  # <-
            c = chain_x.sum()  # <-
            return a, b, c
    """)}, {"utils/pool.py": _src("""
        import torch

        CHAIN_AXIS = 0


        def summaries(chain_means, chains, chain_x):
            a = chain_means.mean(dim=1)
            b = chains.mean(1)
            c = torch.sum(chain_x, dim=CHAIN_AXIS)
            return a, b, c


        def pool_chains(chain_means):
            return chain_means.mean(0)
    """)}),
    "DCFM1501": ({"models/panels.py": _src("""
        import numpy as np
        import torch


        def dense(p, g, P, x):
            a = torch.zeros((p, p))  # <-
            b = torch.empty(g, P, P)  # <-
            c = x.new_zeros((p, p))  # <-
            d = np.zeros((p, p), np.float32)  # <-
            return a, b, c, d
    """)}, {"models/panels.py": _src("""
        import torch


        def packed(n, p, g, P, x):
            a = torch.zeros((3, 3))
            b = torch.zeros((n, p))
            c = x.new_empty((g, P * (P + 1) // 2))
            return a, b, c
    """)}),
    "DCFM1601": ({"models/mm.py": _src("""
        import torch


        def products(a, b, x, y):
            c = torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16))  # <-
            a16 = a.bfloat16()
            d = a16 @ b  # <-
            e = torch.bmm(x.half(), y)  # <-
            return c, d, e
    """)}, {"models/mm.py": _src("""
        import torch


        def mm_bf16(a, b):
            a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
            if a.device.type != "cuda":
                return a16.float() @ b16.float()
            return torch.mm(a16, b16, out_dtype=torch.float32)
    """)}),
    "DCFM1701": ({"models/setup.py": _src("""
        import torch.distributed as dist

        from pkg.parallel.mesh import RankLayout


        def start(rank, world):
            dist.init_process_group("gloo", rank=rank, world_size=world)  # <-
            row = dist.new_group([0, 1])  # <-
            return row, RankLayout(world, rank)  # <-
    """)}, {"parallel/setup.py": _src("""
        import torch.distributed as dist

        from pkg.parallel.mesh import RankLayout


        def start(rank, world):
            dist.init_process_group("gloo", rank=rank, world_size=world)
            row = dist.new_group([0, 1])
            return row, RankLayout(world, rank)
    """)}),
    "DCFM2001": ({"runtime/windows.py": _src("""
        import torch
        import torch.distributed as dist


        def resume_window(meta, total):
            n = torch.cuda.device_count()
            per = total // n  # <-
            w = dist.get_world_size()
            return per, meta["acc"][: total // w]  # <-


        def restore_chains(layout, total):
            return total // len(layout.row_ranks(0))  # <-
    """)}, {"runtime/windows.py": _src("""
        import torch
        import torch.distributed as dist


        def resume_meta(meta):
            meta["topology"] = {"devices": torch.cuda.device_count()}
            if meta["world"] != dist.get_world_size():
                raise ValueError("the topology changed")
            return meta


        def mesh_size(total):
            return total // torch.cuda.device_count()
    """)}),
}


def _package(root, files: dict) -> str:
    """``files`` as modules of a package ``pkg`` under ``root``."""
    pkg = os.path.join(str(root), "pkg")
    for sub in ("", "runtime", "parallel", "models", "ops", "utils"):
        os.makedirs(os.path.join(pkg, sub), exist_ok=True)
        with open(os.path.join(pkg, sub, "__init__.py"), "w") as f:
            f.write("")
    for rel, text in files.items():
        with open(os.path.join(pkg, rel), "w") as f:
            f.write(text)
    return pkg


def _lint(path, *extra) -> list:
    """``python -m dcfm_tpu_torch.analysis PATH --format json``, in
    process: (package-relative path, line, rule) of each finding."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        port_main.main([str(path), "--format", "json", *extra])
    base = path if os.path.isdir(path) else os.path.dirname(path)
    return sorted((os.path.relpath(r["path"], base), r["line"], r["rule"])
                  for r in json.loads(out.getvalue()))


def _marked(files: dict) -> list:
    return sorted((rel, i + 1) for rel, text in files.items()
                  for i, line in enumerate(text.splitlines())
                  if line.endswith("# <-"))


def test_the_cases_are_the_translated_rules():
    assert set(CASES) == port_rules.TRANSLATED
    assert len(port_rules.TRANSLATED) == 15
    assert set(port_rules.RULES) - port_rules.TRANSLATED == {
        "DCFM002", "DCFM401", "DCFM402", "DCFM403", "DCFM501", "DCFM502",
        "DCFM503", "DCFM601", "DCFM602", "DCFM901", "DCFM1001",
        "DCFM1101", "DCFM1102", "DCFM1301", "DCFM1901"}


@pytest.mark.parametrize("rule", sorted(CASES))
def test_a_translated_rule_fires_on_its_torch_hazard(rule, tmp_path):
    """Exactly the marked lines, and no other rule."""
    files = CASES[rule][0]
    found = _lint(_package(tmp_path, files))
    assert {r for _, _, r in found} == {rule}, found
    assert sorted({(p, ln) for p, ln, _ in found}) == _marked(files)


@pytest.mark.parametrize("rule", sorted(CASES))
def test_a_translated_rule_is_silent_on_its_clean_twin(rule, tmp_path):
    assert _lint(_package(tmp_path, CASES[rule][1])) == []


_PROBE = _src("""
    import os

    import torch


    def sweep(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        s = x.sum()
        if s > 0:
            x = x * 2
        n = s.item()
        scale = float(os.environ.get("SCALE", "1"))
        y = torch.matmul(x.to(torch.bfloat16), w.to(torch.bfloat16))
        return y.to(torch.float64) * scale * n


    def resume_trip(x, w, p, total):
        gen = torch.Generator(device="cpu").manual_seed(0)
        buf = torch.zeros((p, p))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sweep(x, w)
        host = out.cpu()
        per = total // torch.cuda.device_count()
        return host, gen, buf, per
""")


def test_the_probe_fires_the_port_rules_and_none_of_the_jax_ones(tmp_path):
    """A captured sweep with a host sync, a branch on a tensor, an
    environment read, a float64 cast and a bf16 product; a constant
    seed, a (p, p) buffer, a blocking .cpu() in a runtime module and a
    live device count in a resume path: the JAX linter saw none of these
    in the port's spelling."""
    path = os.path.join(_package(tmp_path, {"runtime/trip.py": _PROBE}),
                        "runtime", "trip.py")
    want = {"DCFM102", "DCFM201", "DCFM202", "DCFM203", "DCFM301",
            "DCFM801", "DCFM1501", "DCFM1601", "DCFM2001"}
    assert {r for _, _, r in _lint(path)} == want
    assert not {f.rule for f in jax_linter.lint_file(path)} & want


def test_every_port_rule_fires_on_some_firing_source(tmp_path):
    """The port's counterpart of tests/test_lint.py's registry check: the
    translated rules on their firing sources here, the shared ones on
    the JAX package's known-bad fixtures."""
    fired = set()
    for i, rule in enumerate(sorted(CASES)):
        fired |= {r for _, _, r in _lint(
            _package(tmp_path / str(i), CASES[rule][0]))}
    for name in sorted(os.listdir(FIXTURES)):
        if name.startswith("bad_"):
            fired |= {f.rule for f in port_linter.lint_file(
                os.path.join(FIXTURES, name))}
    assert fired == set(port_rules.RULES), set(port_rules.RULES) - fired


_SUPPRESSED = _src("""
    import torch


    def product(a, b):
        return a.half() @ b  # dcfm-torch: ignore[DCFM1601] - a documented escape
""")


def test_a_port_pragma_is_invisible_to_the_jax_linter(tmp_path):
    """The port reads ``# dcfm-torch: ignore``, the JAX linter does not:
    it neither suppresses with it nor calls it stale - while a JAX-form
    pragma on the same line would be DCFM002 to the JAX linter, which
    never fires DCFM1601 on the torch spelling."""
    path = os.path.join(_package(tmp_path, {"models/mm.py": _SUPPRESSED}),
                        "models", "mm.py")
    assert _lint(path) == []
    assert jax_linter.lint_file(path) == []
    jax_form = _SUPPRESSED.replace("dcfm-torch:", "dcfm:")
    assert [f.rule for f in jax_linter.lint_source(
        jax_form, "pkg/models/mm.py")] == ["DCFM002"]
    assert port_linter.lint_source(jax_form, "pkg/models/mm.py") == []


def test_a_stale_port_pragma_is_dcfm002_to_the_port(tmp_path):
    """A ``dcfm-torch`` pragma on a line where its rule no longer fires
    (the product now carries out_dtype) is suppression rot; a JAX-form
    pragma naming a translated rule is the JAX gate's to judge."""
    fixed = _SUPPRESSED.replace("a.half() @ b",
                                "torch.mm(a.half(), b, "
                                "out_dtype=torch.float32)")
    path = os.path.join(_package(tmp_path, {"models/mm.py": fixed}),
                        "models", "mm.py")
    assert _lint(path) == [("mm.py", 5, "DCFM002")]
    found = port_linter.lint_file(path)
    assert "'# dcfm-torch: ignore[DCFM1601]' no longer fires" in \
        found[0].message
    assert jax_linter.lint_file(path) == []
    unknown = fixed.replace("DCFM1601", "DCFM1999")
    assert [f.rule for f in port_linter.lint_source(
        unknown, "pkg/models/mm.py")] == ["DCFM002"]
    jax_form = fixed.replace("dcfm-torch:", "dcfm:")
    assert port_linter.lint_source(jax_form, "pkg/models/mm.py") == []
