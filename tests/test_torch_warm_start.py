"""The port's warm start (``FitConfig.warm_start``) against the JAX
package's: the donor-compatibility rule and its reasons, the state graft,
donors written by either package seeding a chain of the other, the cold
fallbacks, resume's precedence and the re-lineaged streams.

A warm start seeds a NEW chain from another run's checkpoint state, so a
file of either package may be the donor (the Philox refusal of resume does
not apply), and no check here is bitwise across the packages' chains: the
grafted initial state is bitwise the donor's bytes, the decisions and
their reasons are equal, and the warm fit passes the quality rule.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

import dcfm_tpu  # noqa: E402
import dcfm_tpu.runtime.pipeline as jpipeline  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu.config import WarmStart as JWarmStart  # noqa: E402
from dcfm_tpu.runtime import resume as jres  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from dcfm_tpu_torch.config import WarmStart  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.noise import TorchNoise, warm_lineage  # noqa: E402
from dcfm_tpu_torch.obs import run_events  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.runtime import resume as pres  # noqa: E402
from dcfm_tpu_torch.serve.artifact import export_from_checkpoint  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as pck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402


def _cfg(pkg, *, g=2, K=3, C=2, burnin=40, mcmc=40, seed=0, prior="mgp",
         **kw):
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=g, factors_per_shard=K, rho=0.7,
                              prior=prior),
        run=pkg.RunConfig(burnin=burnin, mcmc=mcmc, seed=seed,
                          num_chains=C),
        **kw)


def _fit(pkg, Y, cfg):
    return pkg.fit(Y, cfg, device="cpu") if pkg is dt else pkg.fit(Y, cfg)


def _warm_events(obs_dir) -> list:
    """The warm_start events of a run directory, without the path and the
    recorder's own fields."""
    return [{k: v for k, v in e.items()
             if k not in ("t", "mono", "seq", "run", "role", "checkpoint")}
            for e in run_events(obs_dir) if e["event"] == "warm_start"]


def _quality(S, Y, St) -> float:
    """The quality rule: rel. Frobenius error < 0.25 and <= 2x the sample
    covariance's."""
    err = np.linalg.norm(S - St) / np.linalg.norm(St)
    sample = np.linalg.norm(np.cov(Y, rowvar=False) - St) / np.linalg.norm(St)
    assert err < 0.25 and err <= 2 * sample, (err, sample)
    return err


def _donor_leaves(path: str, n: int) -> list:
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(n)]


def _assert_grafted(init: list, donor: list) -> int:
    """Every grafted leaf's origin block is the donor's bytes; returns the
    leaves whose shape equals the donor's (verbatim)."""
    verbatim = 0
    for i, (got, d) in enumerate(zip(init, donor, strict=True)):
        assert got.ndim == d.ndim, i
        sl = tuple(slice(0, s) for s in d.shape)
        np.testing.assert_array_equal(got[sl], d.astype(got.dtype),
                                      err_msg=f"leaf_{i}")
        verbatim += got.shape == d.shape
    return verbatim


@pytest.fixture
def port_init(monkeypatch):
    """The port's initial chain states, read off each chain's carry as its
    first chunk starts: ``take()`` returns the state leaves (chain-axis
    convention) of the fit that just ran."""
    got = {}
    run_chunk = sampler.ChainRunner.run_chunk

    def capture(self, c, carry, n):
        if carry.iteration == 0 and c not in got:
            got[c] = [t.cpu().numpy().copy()
                      for t in sampler.state_leaves(carry.state)]
        return run_chunk(self, c, carry, n)

    monkeypatch.setattr(sampler.ChainRunner, "run_chunk", capture)

    class Take:
        @staticmethod
        def take():
            C = len(got)
            out = ([np.stack(z) for z in zip(*(got[c] for c in range(C)))]
                   if C > 1 else got[0])
            got.clear()
            return out
    return Take


@pytest.fixture
def jax_init(monkeypatch):
    """The JAX package's initial chain state, captured at its resume
    seam (tests/test_online.py's method)."""
    got = []
    orig = jpipeline.resume_state

    def capture(ctx, init_fn, Yd):
        carry, done, acc_start = orig(ctx, init_fn, Yd)
        got[:] = [np.array(leaf, copy=True)
                  for leaf in jax.tree.leaves(carry.state)]
        return carry, done, acc_start

    monkeypatch.setattr(jpipeline, "resume_state", capture)
    return got


def _rewrite(path: str, *, meta_fn=None, leaf=None) -> None:
    """Rewrite a checkpoint's members: ``meta_fn`` edits the meta in
    place, ``leaf=(name, fn)`` replaces one payload entry (its recorded
    CRC32 kept: a silent corruption)."""
    with np.load(path) as z:
        members = {k: z[k] for k in z.files}
    meta = json.loads(bytes(members["__meta__"]).decode())
    if meta_fn is not None:
        meta_fn(meta)
    if leaf is not None:
        members[leaf[0]] = leaf[1](members[leaf[0]])
    members["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **members)


# ---------------------------------------------------------------------------
# the rule and the graft, against the JAX package's functions
# ---------------------------------------------------------------------------

_DONORS = {
    "compatible": ({}, {}, 8),
    "new shards": ({"g": 2}, {"g": 3}, 8),
    "more donor chains": ({"C": 3}, {"C": 2}, 7),
    "fewer donor chains": ({"C": 2}, {"C": 3}, 6),
    "rank": ({"K": 2}, {}, 8),
    "prior": ({"prior": "horseshoe"}, {}, 8),
    "chain axis appears": ({"C": 1}, {"C": 2}, 8),
    "chain axis disappears": ({"C": 2}, {"C": 1}, 8),
    "format": ({}, {}, 5),
}


@pytest.mark.parametrize("case", sorted(_DONORS))
def test_warm_incompatible_gives_the_jax_packages_reasons(case):
    donor, run, version = _DONORS[case]
    meta = {"version": version,
            "config": pck._config_to_json(_cfg(dt, **donor))}
    port_cfg = _cfg(dt, **run)
    jax_cfg = jck.config_from_checkpoint_meta(
        {"config": pck._config_to_json(port_cfg)})
    got = pres._warm_incompatible(meta, port_cfg)
    assert got == jres._warm_incompatible(meta, jax_cfg)
    assert (got is None) == (case in ("compatible", "new shards",
                                      "more donor chains",
                                      "fewer donor chains"))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_graft_state_leaf_is_the_jax_packages_bit_for_bit(data):
    ndim = data.draw(st.integers(1, 4))
    fresh_shape = tuple(data.draw(st.lists(st.integers(1, 5), min_size=ndim,
                                           max_size=ndim)))
    kind = data.draw(st.sampled_from(["embeds", "embeds", "may exceed",
                                      "extra axis"]))
    if kind == "extra axis":
        old_shape = fresh_shape + (2,)
    else:
        over = int(kind == "may exceed")
        old_shape = tuple(data.draw(st.integers(1, f + over))
                          for f in fresh_shape)
    old_dtype = data.draw(st.sampled_from([np.float32, np.float64]))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**16)))
    old = rng.normal(size=old_shape).astype(old_dtype)
    fresh = rng.normal(size=fresh_shape).astype(np.float32)
    try:
        want = jres._graft_state_leaf(old, fresh)
    except ValueError:
        with pytest.raises(ValueError, match="does not embed"):
            pres._graft_state_leaf(old, fresh)
        return
    got = pres._graft_state_leaf(old, fresh)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape == fresh_shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# donors of one package seeding chains of the other
# ---------------------------------------------------------------------------

def test_a_jax_written_donor_seeds_a_port_chain(tmp_path, port_init):
    """Appended rows (n = 80 -> 100): a JAX-written donor - its config
    naming the TPU backend, as a file written there does - seeds the
    port's two chains.  Lambda, psi and the prior's leaves are the
    donor's bytes, Z and X in their origin block; the port's warm_start
    event is the JAX package's for the same donor and config; the warm fit
    passes the quality rule; the port exports the file too."""
    Y, St = make_synthetic(100, 24, 3, seed=12)
    ck = str(tmp_path / "jax_donor.npz")
    _fit(dcfm_tpu, Y[:80], _cfg(dcfm_tpu, burnin=60, mcmc=60,
                                checkpoint_path=ck))

    def on_tpu(meta):
        meta["config"]["backend"]["backend"] = "jax_tpu"

    _rewrite(ck, meta_fn=on_tpu)
    assert pck.config_from_checkpoint_meta(
        pck.read_checkpoint_meta(ck)).backend.backend == "jax_tpu"
    warm, events = {}, {}
    for pkg in (dt, dcfm_tpu):
        ws = (WarmStart if pkg is dt else JWarmStart)(checkpoint=ck)
        obs = str(tmp_path / f"{pkg.__name__}.events")
        warm[pkg] = _fit(pkg, Y, _cfg(pkg, burnin=10, mcmc=60, obs=obs,
                                      warm_start=ws))
        events[pkg] = _warm_events(obs)
    names = pck.state_leaf_names(warm[dt].config.model)
    init = port_init.take()
    verbatim = _assert_grafted(init, _donor_leaves(ck, len(names)))
    assert events[dt] == events[dcfm_tpu]
    (ev,) = events[dt]
    assert ev["decision"] == "warm" and ev["relineage"] == 1
    assert (ev["leaves"], ev["verbatim_leaves"]) == (len(names), verbatim)
    assert verbatim == len(names) - 2            # Z and X grew
    assert ev["donor_iteration"] == 120
    _quality(warm[dt].Sigma, Y, St)
    art = export_from_checkpoint(ck, Y[:80], str(tmp_path / "art"))
    assert art.meta["provenance"]["source"] == "checkpoint"


def test_a_port_written_donor_seeds_a_jax_chain(tmp_path, jax_init,
                                                port_init):
    """New shards (g = 2 -> 3 at P = 12): a port-written donor seeds a JAX
    chain - the first two shards' state is the donor's bytes - and the
    port's own warm fit from it decides as the JAX package does."""
    Y, St = make_synthetic(150, 36, 3, seed=13)
    ck = str(tmp_path / "port_donor.npz")
    _fit(dt, Y[:, :24], _cfg(dt, burnin=40, mcmc=40, checkpoint_path=ck))
    port_init.take()
    events = {}
    res = {}
    for pkg in (dcfm_tpu, dt):
        ws = (WarmStart if pkg is dt else JWarmStart)(checkpoint=ck)
        obs = str(tmp_path / f"{pkg.__name__}.events")
        res[pkg] = _fit(pkg, Y, _cfg(pkg, g=3, burnin=10, mcmc=60, obs=obs,
                                     warm_start=ws))
        events[pkg] = _warm_events(obs)
    names = pck.state_leaf_names(res[dt].config.model)
    donor = _donor_leaves(ck, len(names))
    assert _assert_grafted(jax_init, donor) == 1      # only X keeps shape
    assert _assert_grafted(port_init.take(), donor) == 1
    assert events[dt] == events[dcfm_tpu]
    assert events[dt][0]["decision"] == "warm"
    _quality(res[dcfm_tpu].Sigma, Y, St)
    _quality(res[dt].Sigma, Y, St)


def test_a_feature_width_mismatch_is_the_jax_packages_cold_start(tmp_path):
    """Same model, another per-shard width P: both packages decide cold
    with the same reason (the donor's and the fresh Lambda shapes)."""
    Y, _ = make_synthetic(40, 30, 3, seed=14)
    ck = str(tmp_path / "donor.npz")
    _fit(dt, Y[:, :24], _cfg(dt, burnin=4, mcmc=4, checkpoint_path=ck))
    events = {}
    for pkg in (dt, dcfm_tpu):
        ws = (WarmStart if pkg is dt else JWarmStart)(checkpoint=ck)
        obs = str(tmp_path / f"{pkg.__name__}.events")
        _fit(pkg, Y, _cfg(pkg, burnin=4, mcmc=4, obs=obs, warm_start=ws))
        events[pkg] = _warm_events(obs)
    assert events[dt] == events[dcfm_tpu]
    assert events[dt][0]["decision"] == "cold"
    assert "feature width / rank mismatch" in events[dt][0]["reason"]


# ---------------------------------------------------------------------------
# the port's graft rules, fallbacks and precedence
# ---------------------------------------------------------------------------

def _donor(tmp_path, Y, name="donor", **kw):
    ck = str(tmp_path / f"{name}.npz")
    _fit(dt, Y, _cfg(dt, burnin=6, mcmc=6, checkpoint_path=ck, **kw))
    return ck


@pytest.mark.parametrize("donor_chains,chains", [(3, 2), (2, 3)])
def test_donor_chain_rows_graft_or_stay_cold(tmp_path, port_init,
                                             donor_chains, chains):
    """More donor chains: the run takes the first rows.  Fewer: the extra
    chains keep their fresh initial state - bitwise a plain fit's."""
    Y, _ = make_synthetic(40, 24, 3, seed=15)
    ck = _donor(tmp_path, Y, C=donor_chains)
    port_init.take()
    cfg = _cfg(dt, C=chains, burnin=2, mcmc=2)
    _fit(dt, Y, cfg)
    plain = port_init.take()
    _fit(dt, Y, dataclasses.replace(cfg, warm_start=WarmStart(ck)))
    warm = port_init.take()
    donor = _donor_leaves(ck, len(warm))
    k = min(chains, donor_chains)
    for got, d, p in zip(warm, donor, plain, strict=True):
        np.testing.assert_array_equal(got[:k], d[:k])
        np.testing.assert_array_equal(got[k:], p[k:])


def test_a_corrupt_donor_is_a_recorded_cold_start(tmp_path, port_init):
    """A donor leaf that fails its CRC32: no raise, a cold decision naming
    the CRC, the fresh decision after it - and the chains start from a
    plain fit's initial state (the init streams are never re-lineaged)."""
    Y, _ = make_synthetic(40, 24, 3, seed=16)
    ck = _donor(tmp_path, Y)
    _rewrite(ck, leaf=("leaf_3", lambda a: a * np.float32(1.5)))
    port_init.take()
    _fit(dt, Y, _cfg(dt, burnin=2, mcmc=2))
    plain = port_init.take()
    obs = str(tmp_path / "events")
    res = _fit(dt, Y, _cfg(dt, burnin=2, mcmc=2, obs=obs,
                           warm_start=WarmStart(ck)))
    assert np.isfinite(res.Sigma).all()
    (ev,) = _warm_events(obs)
    assert ev["decision"] == "cold" and "CRC32" in ev["reason"]
    assert [e["decision"] for e in run_events(obs)
            if e["event"] == "resume_decision"] == ["fresh"]
    for got, p in zip(port_init.take(), plain, strict=True):
        np.testing.assert_array_equal(got, p)
    # an unreadable path is a cold start too
    res = _fit(dt, Y, _cfg(dt, burnin=2, mcmc=2, obs=obs,
                           warm_start=WarmStart(str(tmp_path / "none"))))
    assert _warm_events(obs)[-1]["decision"] == "cold"


class _Killed(BaseException):
    """The kill double's signal: a BaseException, past the save-failure
    policy."""


def test_resume_takes_precedence_over_the_warm_start(tmp_path,
                                                     monkeypatch):
    """A warm refit killed after its second save and relaunched with the
    same config resumes its own file - decision "resume", no warm_start
    event - and ends bitwise the uninterrupted warm refit."""
    Y, _ = make_synthetic(40, 24, 3, seed=17)
    donor = _donor(tmp_path, Y)
    saves, kill = [], [False]
    save = pipeline.save_checkpoint

    def save_then_kill(path, leaves, cfg, **kw):
        save(path, leaves, cfg, **kw)
        saves.append(path)
        if len(saves) == 2 and kill[0]:
            raise _Killed()

    monkeypatch.setattr(pipeline, "save_checkpoint", save_then_kill)

    def cfg(name):
        ck = str(tmp_path / f"{name}.npz")
        return dataclasses.replace(
            _cfg(dt, checkpoint_path=ck, resume="auto",
                 checkpoint_every_chunks=1, warm_start=WarmStart(donor),
                 obs=ck + ".events"),
            run=dt.RunConfig(burnin=6, mcmc=8, seed=0, num_chains=2,
                             chunk_size=4))

    ref = _fit(dt, Y, cfg("ref"))
    saves.clear()
    kill[0] = True
    with pytest.raises(_Killed):
        _fit(dt, Y, cfg("killed"))
    kill[0] = False
    resumed = _fit(dt, Y, cfg("killed"))
    np.testing.assert_array_equal(resumed.Sigma, ref.Sigma)
    evs = run_events(str(tmp_path / "killed.npz.events"))
    starts = [i for i, e in enumerate(evs) if e["event"] == "fit_start"]
    second = evs[starts[1]:]
    assert [e["decision"] for e in second
            if e["event"] == "resume_decision"] == ["resume"]
    assert not [e for e in second if e["event"] == "warm_start"]
    assert [e["decision"] for e in evs[:starts[1]]
            if e["event"] == "warm_start"] == ["warm"]


def test_the_warm_chain_runs_on_re_lineaged_streams(tmp_path, monkeypatch):
    """The warm fit's runner draws on ``warm_lineage(relineage)``: its first
    sweep's draws differ from the donor's (the plain lineage), from a
    rewound chain's and from another relineage's; the init stream is the
    plain one."""
    Y, _ = make_synthetic(40, 24, 3, seed=18)
    ck = _donor(tmp_path, Y)
    lineages = []
    init = sampler.ChainRunner.__init__

    def spy(self, noise, *a, **k):
        lineages.append(noise.lineage)
        init(self, noise, *a, **k)

    monkeypatch.setattr(sampler.ChainRunner, "__init__", spy)
    _fit(dt, Y, _cfg(dt, burnin=2, mcmc=2,
                     warm_start=WarmStart(ck, relineage=3)))
    assert lineages == [warm_lineage(3)] == [(0, 3)]

    def first_draw(lineage):
        return TorchNoise(0, "cpu", lineage).sweep(0, 0).normal(1, (4, 3))

    draws = [first_draw(lin) for lin in ((), (1,), (0, 1), (0, 3))]
    for i in range(len(draws)):
        for j in range(i):
            assert not torch.equal(draws[i], draws[j]), (i, j)
    a = TorchNoise(0, "cpu", (0, 3)).init(0).normal(1, (4, 3))
    assert torch.equal(a, TorchNoise(0, "cpu").init(0).normal(1, (4, 3)))
