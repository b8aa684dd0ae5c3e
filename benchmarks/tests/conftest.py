"""The benchmark's own tests: run from the root of the repo with

    python -m pytest benchmarks/tests -q

They run the harness, the reference and the program on the CPU at tiny
sizes; the ones marked ``gpu`` need the card and skip without it."""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

from fitbench import spec  # noqa: E402

# the cells' shapes cut to what a test run holds: 4 shards of 8 columns,
# 40 rows, 4 factors a shard, 12 + 12 sweeps
TINY_DATA = {"n": 40, "p": 30, "k_true": 3, "noise": 0.2}
TINY_SCHEDULE = {"burnin": 12, "mcmc": 12}


def tiny_cell(name: str) -> spec.Cell:
    """Cell ``name`` of BENCHMARK.json at a tiny size, on the CPU: its
    configuration's model, knobs and limits, its traffic's thinning."""
    cell = spec.load_cell(name)
    config = dict(cell.config, data=dict(TINY_DATA),
                  model=dict(cell.config["model"], num_shards=4,
                             factors_per_shard=4),
                  backend=dict(cell.config["backend"], backend="auto"))
    traffic = dict(cell.traffic, **TINY_SCHEDULE)
    traffic["mcmc"] -= traffic["mcmc"] % int(traffic["thin"])
    return spec.Cell(cell.name, cell.chips, config, traffic,
                     cell.end_to_end, cell.per_layer)


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    """The card, or a skip: decided at run time, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
