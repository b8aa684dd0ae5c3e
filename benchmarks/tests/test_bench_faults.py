"""A run with the timed path broken underneath comes out not correct.

Each cell is driven on the CPU at a tiny size past the harness's look for
a card (fitbench/cell.run_cell), with one fault planted in the program:

* a step that returns its state unchanged (the Gibbs sweep a no-op);
* half of the batch left out, the mean taken over the rest (every other
  saved draw dropped from the accumulator, the others added twice);
* an answer altered where it is produced (one panel of the posterior
  mean 10% off as the fetch casts it for the link).

The cells run on one card, so there is no exchange between chips to
leave out."""

import time

import pytest

from conftest import tiny_cell
from fitbench import cell as runner


def _unchanged_step(draws, Y, state, cfg, prior, reduce_fn=None):
    import torch
    return state, torch.zeros_like(state.ps)


def _half_the_draws(add):
    calls = []

    def add_some(*a, **kw):
        calls.append(1)
        if len(calls) % 2:
            add(*a, **kw)
            add(*a, **kw)
    return add_some


def _altered_answer(cast):
    def cast_altered(u, mode):
        u[1].mul_(1.1)
        return cast(u, mode)
    return cast_altered


FAULTS = ["unchanged_step", "half_the_draws", "altered_answer"]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", ["ns_mgp.fit", "c5_hs_adapt.fit",
                                  "c5_hs_adapt.thin10"])
def test_a_broken_path_is_not_correct(name, fault, monkeypatch):
    from dcfm_tpu_torch.models import sampler
    from dcfm_tpu_torch.runtime import fetch

    if fault == "unchanged_step":
        monkeypatch.setattr(sampler, "gibbs_sweep", _unchanged_step)
    elif fault == "half_the_draws":
        monkeypatch.setattr(sampler, "add_panels",
                            _half_the_draws(sampler.add_panels))
    else:
        monkeypatch.setattr(fetch, "cast_for_link",
                            _altered_answer(fetch.cast_for_link))
    out = runner.run_cell(tiny_cell(name), 2 ** 31 + 29, 0.2, False, "cpu",
                          time.perf_counter())
    assert out["correct"] is False and out["failed"] == 1
    assert any(r["value"] > r["limit"] for r in out["compared"].values())
