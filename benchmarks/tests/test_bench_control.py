"""The control comes out not correct, on the card.

The control is the plain reference put in the program's place and
computed in the nearest precision below the configuration's float32:
TF32 products.  At a size a test run holds (each cell's configuration
and traffic cut to 16 shards and 200 sweeps), it is judged as a fit is
(fitbench/check.py: against the float64 reference of the same seed, in
units of the float32 reference's gap) by the cell's own numbers and
limits, and fails one; the program's fit of the same seed passes.  The
readings at the cells' own sizes are calibrate.py's (PERF.md)."""

import pytest
import torch

from fitbench import cell as runner, check, data, spec

pytestmark = pytest.mark.gpu


def _mid(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    P = -(-int(c.config["data"]["p"]) // int(c.config["model"]
                                               ["num_shards"]))
    config = dict(c.config, data=dict(c.config["data"], p=16 * P),
                  model=dict(c.config["model"], num_shards=16))
    thin = int(c.traffic["thin"])
    traffic = dict(c.traffic, burnin=100, mcmc=100 - 100 % thin)
    return spec.Cell(c.name, 1, config, traffic, [], [])


@pytest.mark.parametrize("name", ["ns_mgp.fit", "c5_hs_adapt.fit"])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_the_control_fails_and_the_program_passes(name, seed, cuda):
    import dcfm_tpu_torch

    c = _mid(name)
    Y = data.make_data(c.config["data"], seed, cuda)
    rs = data.run_seed(seed, 0)
    exact, prep = check.reference(Y, c.config, c.traffic, rs, cuda,
                                  dtype=torch.float64)
    plain, _ = check.reference(Y, c.config, c.traffic, rs, cuda)
    low, _ = check.reference(Y, c.config, c.traffic, rs, cuda, tf32=True)
    control = check.numbers(c.config, check.control_answer(c.config, low,
                                                           prep),
                            exact, plain, prep)
    assert not check.verdict(c.config, control)[0], control
    res = dcfm_tpu_torch.fit(Y, runner.fit_config(c.config, c.traffic, rs),
                             device=cuda)
    sound = check.numbers(c.config, runner.answer_of(c.config, res), exact,
                          plain, prep)
    assert check.verdict(c.config, sound)[0], sound
