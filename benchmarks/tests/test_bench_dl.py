"""The Dirichlet-Laplace configuration, ns_dl: its plain reference
(fitref/dl.py) against the program on the CPU, the fit its file builds,
and the readers of the GIG sampler's stage time and counters, for its
cell ``ns_dl.fit``."""

import hashlib
import os

import pytest
import torch

import conftest
from fitbench import cell as runner, check, data, spec
from fitref import dl


def tiny_cell() -> spec.Cell:
    """ns_dl.fit at a tiny size, as conftest.tiny_cell cuts a cell."""
    return conftest.tiny_cell("ns_dl.fit")


# SHA-256 of the reference's panels for tiny_cell() on data seed 1 and
# run seed 3, on the CPU: pinned, as test_bench_reference.py pins the
# other references'
DIGESTS = {
    torch.float64:
        "c8ab66e9d42284855b5f0c9c346016d809fcf76c0fb51964d706d9f308dcd4b5",
    torch.float32:
        "0c75045d6ce86a07e548464281352c71245d8d77587b37c7f9dd763842d9fa19",
}


class _Rounds:
    """Hands out fixed uniforms, in the order asked: to the program's
    sampler as one chain's draws (``part`` ignored), and to the
    reference's as a stack of one chain."""

    def __init__(self, uniforms, stacked: bool):
        self._u, self._stacked = list(uniforms), stacked

    def uniform(self, site, shape, *, part=None):
        u = self._u.pop(0)
        assert tuple(u.shape) == tuple(shape)
        return u[None] if self._stacked else u


def _gig_case(p: float, G=3, P=40, K=8, seed=0, exhaust=None):
    """GIG(p, 1, b) parameters in the DL conditionals' regimes (b = 2
    |theta|, some at the 1e-8 floor) and three rounds of uniforms; with
    ``exhaust`` the element at that index gets W = 1 in every round, which
    no candidate below the log-density's peak accepts."""
    gen = torch.Generator().manual_seed(seed)
    theta = torch.randn((G, P, K), generator=gen) * 0.3
    theta[:, :4] = 0.0
    b = 2.0 * torch.clamp_min(theta.abs(), 1e-8)
    U, V, W = (torch.rand((G, dl.ROUNDS, P, K), generator=gen)
               for _ in range(3))
    if exhaust is not None:
        g, j, h = exhaust
        W[g, :, j, h] = 1.0
    return b, (U, V, W)


@pytest.mark.parametrize("p", [-0.5, -4.0, 1.5])
def test_the_masked_loop_gig_is_the_programs_gig(p):
    """The reference's early-exit loop and the program's all-rounds
    sampler, on the same uniforms, draw the same values, an element that
    exhausts all 64 rounds included (both then take the peak of Devroye's
    log-density, mapped back)."""
    from dcfm_tpu_torch.ops import gig as program

    b, rounds = _gig_case(p, exhaust=(1, 7, 3))
    got = program.gig(_Rounds(rounds, False), 4, p, 1.0, b)
    want = dl.gig(_Rounds(rounds, True), p, 1.0, b[None])[0]
    torch.testing.assert_close(want, got, rtol=1e-5, atol=0)
    lam, omega = abs(p), torch.sqrt(b[1, 7, 3]).item()
    mode = lam / omega + (1.0 + (lam / omega) ** 2) ** 0.5
    peak = (b[1, 7, 3].item() ** 0.5) * (1.0 / mode if p < 0 else mode)
    assert got[1, 7, 3].item() == pytest.approx(peak, rel=1e-5)
    assert want[1, 7, 3].item() == pytest.approx(peak, rel=1e-5)


def test_the_configuration_builds_a_dl_fit_and_names_its_reference():
    cell = spec.load_cell("ns_dl.fit")
    assert cell.chips == 1
    assert [cell.traffic[k] for k in ("burnin", "mcmc", "thin")] == [500,
                                                                     500, 5]
    assert {m["name"] for m in cell.per_layer} >= {"sweep.gig_ms",
                                                   "gig.rounds_used_pct"}
    assert {"data", "model", "run", "backend", "fit", "answer", "limits",
            "source", "reduced"} <= set(cell.config)
    assert cell.config["name"] == "ns_dl" and cell.config["reduced"] == []
    assert cell.config["reference"] == "benchmarks/fitref/dl.py"
    assert check.reference_module(cell.config).DL is not None
    model = runner.fit_config(cell.config, cell.traffic, 2 ** 33 + 1).model
    assert model.prior == "dl" and model.dl.a == 0.5


@pytest.mark.parametrize("model", [{"rank_adapt": True}, {"prior": "mgp"}])
def test_the_reference_refuses_what_it_does_not_write_out(model):
    c = tiny_cell()
    Y = data.make_data(c.config["data"], 1, "cpu")
    with pytest.raises(NotImplementedError) as e:
        dl.posterior_mean(Y, dict(c.config["model"], **model), c.traffic,
                          3, 2, "cpu")
    assert ("rank_adapt" if "rank_adapt" in model else "'mgp'") in str(
        e.value)


@pytest.fixture(scope="module")
def _tiny():
    """The program's torch_cpu fit of tiny_cell() on data seed 1, run
    seed 3, and the reference's panels in float64 and float32."""
    import dcfm_tpu_torch

    c = tiny_cell()
    Y = data.make_data(c.config["data"], 1, "cpu")
    res = dcfm_tpu_torch.fit(Y, runner.fit_config(c.config, c.traffic, 3),
                             device="cpu")
    exact, prep = check.reference(Y, c.config, c.traffic, 3, "cpu",
                                  dtype=torch.float64)
    plain, _ = check.reference(Y, c.config, c.traffic, 3, "cpu")
    return c, res, exact, plain, prep


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_the_reference_panels_are_pinned(_tiny, dtype):
    _, _, exact, plain, _ = _tiny
    panels = exact if dtype == torch.float64 else plain
    digest = hashlib.sha256(panels.contiguous().numpy().tobytes())
    assert digest.hexdigest() == DIGESTS[dtype]


def test_the_program_agrees_with_the_reference_and_a_half_does_not(_tiny):
    """The program's Sigma is as far from the float64 reference as the
    float32 reference is, within a factor 2 (0.52 when pinned), and
    passes the configuration's limit; the float32 reference's panels rounded to
    float16, put in the program's place, are more than 4 times as far
    (4.89 when pinned).  At 24 sweeps the chain's own amplification of
    rounding, not the panels' last bits, sets the float32 gap, so the
    configuration's limit, set for 1,000 sweeps on the card, is not the
    test's."""
    c, res, exact, plain, prep = _tiny
    got = check.numbers(c.config, res.Sigma, exact, plain, prep)
    assert got["sigma_err_ratio"] <= 2.0, got
    assert check.verdict(c.config, got)[0], got
    half = plain.to(torch.float16).to(plain.dtype)
    control = check.numbers(c.config,
                            check.control_answer(c.config, half, prep),
                            exact, plain, prep)
    assert control["sigma_err_ratio"] > 4.0, control


def _ctx(graphs, traced=True):
    rec = runner.FitRecord(seconds=4.0, phase={"chain_s": 3.0},
                           graphs=graphs, launches={}, sweeps=1000,
                           chains=2, saved=100)
    return runner.Context(shape={"G": 64, "n": 500, "P": 157, "K": 8},
                          fits=[rec], traced=rec if traced else None,
                          trace=None)


def test_the_gig_readers_read_their_keys_and_nothing_without_them():
    graphs = {"unroll": 1, "stage_samples": 4,
              "stage_ms": {"prior_update": 1.1, "gig": 0.8},
              "gig": {"draws": 100, "rounds_evaluated": 6400,
                      "rounds_needed": 160, "unaccepted": 0}}
    gig_ms = spec.metric_reader("sweep.gig_ms")
    used = spec.metric_reader("gig.rounds_used_pct")
    assert gig_ms.read(_ctx(graphs)) == 0.8
    assert used.read(_ctx(graphs)) == pytest.approx(2.5)
    for bare in ({"unroll": 1, "stage_samples": 4,
                  "stage_ms": {"prior_update": 1.1}},
                 {"unroll": 1, "stage_samples": 0, "stage_ms": {}},
                 {"unroll": 1}):
        assert gig_ms.read(_ctx(bare)) is None
        assert used.read(_ctx(bare)) is None
    assert gig_ms.read(_ctx(graphs, traced=False)) is None
    assert used.read(_ctx(graphs, traced=False)) is None
