"""The port's chain in trips (``RunConfig.sweep_unroll``), on the CPU: the
draws a CUDA graph consumes (a recorded recipe, pre-drawn into static
tensors) are the draws of the loop of single sweeps, bit for bit; the
trip's save pattern is the JAX package's per-iteration save condition; any
unroll gives bitwise the same fit; and ``sweep_unroll`` is the JAX
package's field, default and validation.  On the CPU every trip runs
eagerly, so these tests reach all of the trip code but the capture (the
card tests in tests/test_torch_gpu.py hold the graphs against the eager
chain).
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu import config as jconfig  # noqa: E402
from dcfm_tpu.models import sampler as jsampler  # noqa: E402
from dcfm_tpu_torch import (  # noqa: E402
    BackendConfig, FitConfig, ModelConfig, RunConfig, fit)
from dcfm_tpu_torch.config import validate  # noqa: E402
from dcfm_tpu_torch.models.conditionals import gibbs_sweep  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.models.sampler import (  # noqa: E402
    ChainRunner, init_chain, save_pattern, state_leaves, trip_lengths)
from dcfm_tpu_torch.noise import (  # noqa: E402
    BufferedDraws, RecordingDraws, TorchNoise, draw_into)
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Launch-bound sizes: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# every path whose draws differ: the psi draw (resid: standard gammas of an
# alpha built on the device; gram: Exp(1) sums and a normal), the Lambda
# kernel (K1, K4 under bf16, K2 fused), the MGP prior (normals, gammas)
PATHS = [("resid", "f32", "auto"), ("gram", "f32", "pallas"),
         ("resid", "bf16", "auto"), ("gram", "bf16", "auto"),
         ("resid", "f32", "pallas-fused"), ("gram", "f32", "pallas-fused")]


def _model(sse_mode, compute_dtype, lambda_kernel, **kw):
    return ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8,
                       sse_mode=sse_mode, compute_dtype=compute_dtype,
                       lambda_kernel=lambda_kernel, **kw)


def _data(G=2, n=20, p=12, seed=4):
    Y, _ = make_synthetic(n, p, 2, seed=seed)
    return torch.as_tensor(preprocess(Y, G, seed=0).data)


def _equal_states(a, b):
    return all(torch.equal(x, y)
               for x, y in zip(state_leaves(a), state_leaves(b), strict=True))


@pytest.mark.parametrize("sse_mode,compute_dtype,lambda_kernel", PATHS)
def test_recorded_recipe_replays_torch_noise_bitwise(sse_mode, compute_dtype,
                                                     lambda_kernel):
    """One sweep drawn live from TorchNoise, recorded, then its recipe
    pre-drawn for the same iteration into static slots and handed out by
    BufferedDraws: every slot is the live variate and the sweep's output
    is bitwise the same; then a trip of 3 sweeps from pre-drawn slots
    equals 3 live sweeps."""
    cfg = _model(sse_mode, compute_dtype, lambda_kernel)
    prior, Y, noise = make_prior(cfg), _data(), TorchNoise(7, "cpu")
    state0 = init_chain(noise.init(1), Y, cfg, prior).state
    recipe = []
    live, sse_live = gibbs_sweep(RecordingDraws(noise.sweep(1, 5), recipe),
                                 Y, state0, cfg, prior)
    kinds = {c.kind for c in recipe}
    assert ("standard_gamma" in kinds) and ("normal" in kinds)
    assert ("exponential" in kinds) == (sse_mode == "gram")
    slots = [torch.full(c.shape, float("nan")) for c in recipe]
    draw_into(noise.sweep(1, 5), recipe, slots)
    fresh = noise.sweep(1, 5)
    for call, slot in zip(recipe, slots, strict=True):
        if call.kind == "standard_gamma":
            want = fresh.standard_gamma(call.site, call.alpha, part=call.part)
        else:
            want = getattr(fresh, call.kind)(call.site, call.shape,
                                             part=call.part)
        assert torch.equal(slot, want), call[:4]
    buffered = BufferedDraws(recipe, slots)
    out, sse = gibbs_sweep(buffered, Y, state0, cfg, prior)
    buffered.finish()
    assert _equal_states(out, live) and torch.equal(sse, sse_live)

    # a trip: 3 sweeps from slots drawn ahead, against 3 live sweeps
    trip = [torch.empty((3, *c.shape)) for c in recipe]
    for j in range(3):
        draw_into(noise.sweep(1, 9 + j), recipe, [s[j] for s in trip])
    a = b = state0
    for j in range(3):
        a, _ = gibbs_sweep(noise.sweep(1, 9 + j), Y, a, cfg, prior)
        d = BufferedDraws(recipe, [s[j] for s in trip])
        b, _ = gibbs_sweep(d, Y, b, cfg, prior)
        d.finish()
    assert _equal_states(a, b)


def test_buffered_draws_refuse_what_the_recipe_does_not_hold():
    """A call out of the recorded order, a missing or an extra call, and a
    standard-Gamma alpha that changed since the recording (it would depend
    on the chain state) are refused, the last by its site and part."""
    noise = TorchNoise(0, "cpu")
    recipe = []
    rec = RecordingDraws(noise.sweep(0, 0), recipe)
    rec.normal(1, (2, 3))
    rec.standard_gamma(4, torch.full((2,), 3.5), part=1)
    slots = [torch.zeros(2, 3), torch.zeros(2)]
    with pytest.raises(RuntimeError, match="recorded recipe"):
        BufferedDraws(recipe, slots).normal(1, (3, 2))
    with pytest.raises(RuntimeError, match="recorded recipe"):
        BufferedDraws(recipe, slots).exponential(1, (2, 3))
    d = BufferedDraws(recipe, slots)
    d.normal(1, (2, 3))
    with pytest.raises(ValueError, match="site 4 part 1.*chain state"):
        d.standard_gamma(4, torch.tensor([3.5, 4.0]), part=1)
    d = BufferedDraws(recipe, slots)
    assert d.normal(1, (2, 3)) is slots[0]
    with pytest.raises(RuntimeError, match="made 1 draws"):
        d.finish()
    assert d.standard_gamma(4, torch.full((2,), 3.5), part=1) is slots[1]
    d.finish()
    with pytest.raises(RuntimeError, match="no further draw"):
        d.normal(1, (2, 3))


def _jax_save(start, length, burnin, thin):
    """The JAX chunk's per-iteration ``save`` (run_chunk's body), on the
    schedule as run_chunk receives it (schedule_array)."""
    sched = jsampler.schedule_array(jconfig.RunConfig(
        burnin=burnin, mcmc=thin, thin=thin))
    b, t = sched[0].astype(jnp.int32), sched[1].astype(jnp.int32)
    it = start + 1 + jnp.arange(length, dtype=jnp.int32)
    return tuple(bool(v) for v in np.asarray(
        jnp.logical_and(it > b, (it - b) % t == 0)))


def test_save_pattern_is_the_jax_save_condition():
    """Over a grid of (start, T, burnin, thin) with the burn-in boundary
    inside, before and after the trip: the JAX condition, and the JAX
    saved-draw count rising by one exactly on the saved iterations."""
    for start, T, burnin, thin in itertools.product(
            (0, 1, 7, 13, 40), (1, 2, 5, 8), (0, 3, 11, 17), (1, 2, 3, 4)):
        pat = save_pattern(start, T, burnin, thin)
        assert pat == _jax_save(start, T, burnin, thin), (start, T, burnin,
                                                          thin)
        counts = [jsampler.num_saved_draws(start + j, burnin, thin)
                  for j in range(T + 1)]
        assert pat == tuple(b - a == 1 for a, b in zip(counts, counts[1:]))


def test_trip_lengths_are_the_scan_unroll_with_its_remainder():
    assert trip_lengths(13, 5) == [5, 5, 3]
    assert trip_lengths(10, 5) == [5, 5]
    assert trip_lengths(3, 8) == [3]
    assert trip_lengths(4, 1) == [1, 1, 1, 1]


def _cadence_cfg(unroll):
    # tests/test_packed_acc.py's cadence schedule: chunk 13, thin 3,
    # unroll 5 - nothing divides anything
    return FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8),
        run=RunConfig(burnin=17, mcmc=21, thin=3, seed=0, chunk_size=13,
                      sweep_unroll=unroll, num_chains=2))


def test_sweep_unroll_preserves_cadence_and_results():
    """The port's counterpart of test_packed_acc's cadence test: trips of
    5 land burn-in and thin boundaries where trips of 1 do; every trace
    row, the packed panels, Sigma and each chain's state are identical."""
    Y, _ = make_synthetic(40, 48, 2, seed=5)
    r1 = fit(Y, _cadence_cfg(1), device="cpu")
    r5 = fit(Y, _cadence_cfg(5), device="cpu")
    assert r1.graphs["unroll"] == 1 and r5.graphs["unroll"] == 5
    np.testing.assert_array_equal(r1.traces, r5.traces)
    np.testing.assert_array_equal(r1.upper_panels, r5.upper_panels)
    np.testing.assert_array_equal(r1.Sigma, r5.Sigma)
    assert _equal_states(r1.state, r5.state)      # both chains, stacked
    # 38 iterations in chunks of 13 / 13 / 12, trips of 5 and remainders
    assert r5.graphs == {"unroll": 5, "captured": 0, "capture_s": 0.0,
                         "replays": 0, "eager_trips": 2 * 9,
                         "stage_ms": {}, "stage_samples": 0}


def test_auto_unroll_is_one_on_the_cpu():
    Y, _ = make_synthetic(30, 8, 2, seed=0)
    cfg = dataclasses.replace(_cadence_cfg(0), run=RunConfig(burnin=3,
                                                             mcmc=3))
    assert fit(Y, cfg, device="cpu").graphs["unroll"] == 1


def test_parity_with_jax_fit_at_unroll_5():
    """The port's fit and the JAX package's fit at sweep_unroll=5 agree
    statistically, in tests/test_torch_fit.py's 0.05 band (different RNG
    streams, same model; the JAX fit runs its Pallas kernels in interpret
    mode)."""
    Y, _ = make_synthetic(120, 48, 3, seed=5)
    run = dict(burnin=400, mcmc=400, seed=0, sweep_unroll=5)
    jcfg = dcfm_tpu.FitConfig(
        model=dcfm_tpu.ModelConfig(num_shards=2, factors_per_shard=3,
                                   rho=0.7, lambda_kernel="pallas"),
        run=dcfm_tpu.RunConfig(**run),
        backend=dcfm_tpu.BackendConfig(sse_mode="gram"))
    cfg = FitConfig(
        model=ModelConfig(num_shards=2, factors_per_shard=3, rho=0.7,
                          lambda_kernel="pallas"),
        run=RunConfig(**run), backend=BackendConfig(sse_mode="gram"))
    S_jx = dcfm_tpu.fit(Y, jcfg).Sigma
    S_pt = fit(Y, cfg, device="cpu").Sigma
    assert np.linalg.norm(S_pt - S_jx) / np.linalg.norm(S_jx) < 0.05


def test_negative_sweep_unroll_is_refused_as_jax_refuses_it():
    run = dict(burnin=2, mcmc=2, sweep_unroll=-1)
    with pytest.raises(ValueError) as port:
        validate(FitConfig(model=ModelConfig(num_shards=2,
                                             factors_per_shard=2, rho=0.5),
                           run=RunConfig(**run)), 30, 8)
    with pytest.raises(ValueError) as jax_:
        jconfig.validate(jconfig.FitConfig(
            model=jconfig.ModelConfig(num_shards=2, factors_per_shard=2,
                                      rho=0.5),
            run=jconfig.RunConfig(**run)), 30, 8)
    assert str(port.value) == str(jax_.value)


def test_runner_refuses_what_it_cannot_run():
    cfg = _model("resid", "f32", "auto")
    prior, Y, noise = make_prior(cfg), _data(), TorchNoise(0, "cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        ChainRunner(noise, Y, cfg, prior, burnin=1, thin=1, graphs=True)
    with pytest.raises(ValueError, match="unroll"):
        ChainRunner(noise, Y, cfg, prior, burnin=1, thin=1, unroll=0)
    # a chain's own carry is copied into the runner's static one (fit's
    # chunk-major loop), so it must have the runner's shapes: one of
    # another width is refused by the copy, and the static carry is left
    # as it was
    runner = ChainRunner(noise, Y, cfg, prior, burnin=1, thin=1, unroll=2)
    own = runner.run_chunk(0, runner.new_chain(0), 2)[0]
    other = init_chain(noise.init(0), Y[:, :, :-1].contiguous(), cfg, prior)
    with pytest.raises(RuntimeError):
        runner.run_chunk(0, other, 2)
    assert own.iteration == 2 and runner.carry.iteration == 2


def test_runner_chains_share_one_carry_and_restart_cleanly():
    """Chain 1 run after chain 0 on the runner's one carry is the chain 1
    a fresh runner gives: the reset leaves nothing of chain 0 behind."""
    cfg = _model("gram", "f32", "pallas")
    prior, Y, noise = make_prior(cfg), _data(), TorchNoise(3, "cpu")

    def run(chains):
        runner = ChainRunner(noise, Y, cfg, prior, burnin=2, thin=2,
                             unroll=3)
        for c in chains:
            carry = runner.init_chain(c)
            carry, _, trace = runner.run_chunk(c, carry, 7)
        return carry, trace

    a, ta = run([0, 1])
    b, tb = run([1])
    assert _equal_states(a.state, b.state) and torch.equal(ta, tb)
    assert torch.equal(a.sigma_acc, b.sigma_acc)
    assert torch.equal(a.health, b.health) and a.iteration == 7
