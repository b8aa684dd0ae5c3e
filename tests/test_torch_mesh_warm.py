"""Warm starts on the shard mesh (dcfm_tpu_torch/runtime/resume.py
``_try_warm_start`` with ``ResumeContext.mesh``), on 4 gloo ranks of the
CPU.

Each rank grafts the donor's GLOBAL state leaves into its block of the
fresh state (``graft_block`` at ``parallel/shard.leaf_block``'s origin),
so the blocks of every rank make up the one-device graft - the JAX
package's ``_graft_state_leaf`` on the whole leaf - under appended rows
(n 50 -> 60) and new shards (g 8 -> 12), on a packed grid and with every
chain on every rank.  The decision is one for the mesh: warm only when
every rank grafted, else a recorded cold start on every rank.  The warm
streams are re-lineaged on every rank as on one device, so a warm mesh
fit is within the JAX package's mesh band of the one-device warm fit,
and a 1-rank world is it bit for bit.  ``permute=False``: under
``permute=True`` new shards graft onto other columns in both packages
(ROADMAP).
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.runtime import resume as jres  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import api  # noqa: E402
from dcfm_tpu_torch.config import WarmStart  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.obs import run_events  # noqa: E402
from dcfm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dcfm_tpu_torch.parallel import shard  # noqa: E402
from dcfm_tpu_torch.runtime import resume  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402

G, K, RANKS = 8, 3, 4
RTOL, ATOL = 1e-3, 1e-4       # tests/test_shard.py's mesh-parity band
# (label, data rows, columns, shards) of each warm refit of the donor's
# 50 x 96 data on 8 shards of 12 columns
CASES = {"appended rows": (60, 96, G), "new shards": (50, 144, 12)}


@pytest.fixture(autouse=True)
def _bounded():
    with deadline(180):
        yield


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(60, 144, 3, seed=9)
    return Y


def _cfg(g=G, C=2, mesh=0, **kw):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=g, factors_per_shard=K, rho=0.6),
        run=dt.RunConfig(burnin=6, mcmc=8, thin=2, seed=3, num_chains=C,
                         chunk_size=4),
        backend=dt.BackendConfig(backend="torch_cpu", sse_mode="gram",
                                 mesh_devices=mesh),
        permute=False, **kw)


@pytest.fixture(scope="module")
def donor(tmp_path_factory):
    """A finished 2-chain one-device fit of the first 50 rows and 96
    columns, its state the donor of every warm refit here."""
    path = str(tmp_path_factory.mktemp("donor") / "donor.npz")
    dt.fit(_data()[:50, :96], _cfg(checkpoint_path=path))
    return path


def _warm(donor, case, obs, mesh=0, one_rank=False, C=2):
    n, p, g = CASES[case]
    cfg = _cfg(g, C, mesh, warm_start=WarmStart(donor), obs=obs)
    if not one_rank:
        return dt.fit(_data()[:n, :p], cfg)
    with mock.patch.object(api, "_fit", functools.partial(
            api._fit, one_rank_mesh=True)):
        return dt.fit(_data()[:n, :p], cfg)


def _decisions(obs):
    return [(e["decision"], e.get("reason")) for e in run_events(obs)
            if e["event"] == "warm_start"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_a_warm_mesh_fit_is_the_one_device_warm_fit(donor, tmp_path, case):
    """Appended rows and new shards (g = 12: a packed grid of 2 chain rows
    of 2 ranks, 6 shards each): decision warm on the mesh and on one
    device, recorded once, and the panels and state within the band."""
    one = _warm(donor, case, str(tmp_path / "one"))
    mesh = _warm(donor, case, str(tmp_path / "mesh"), RANKS)
    assert _decisions(str(tmp_path / "one")) == [("warm", None)]
    assert _decisions(str(tmp_path / "mesh")) == [("warm", None)]
    np.testing.assert_allclose(mesh.sigma_blocks, one.sigma_blocks,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mesh.state.Lambda, one.state.Lambda,
                               rtol=RTOL, atol=ATOL)


def test_a_one_rank_world_is_the_one_device_warm_fit_bit_for_bit(
        donor, tmp_path):
    one = _warm(donor, "new shards", "off")
    ranked = _warm(donor, "new shards", str(tmp_path / "r"), one_rank=True)
    assert _decisions(str(tmp_path / "r")) == [("warm", None)]
    np.testing.assert_array_equal(ranked.Sigma, one.Sigma)
    for a, b in zip(sampler.state_leaves(ranked.state),
                    sampler.state_leaves(one.state), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case,C", [("appended rows", 2),
                                    ("new shards", 2),
                                    ("appended rows", 3)])
def test_each_rank_grafts_the_donor_at_the_jax_package_s_offsets(
        donor, case, C):
    """Every rank's graft of the port-written donor file into its block of
    a fresh global state (packed grids, and 3 chains on every rank, where
    the donor's 2 chains leave the third on its fresh init), put back
    together: the JAX package's graft of the whole leaf, bit for bit (the
    JAX package reads port checkpoints)."""
    n, p, g = CASES[case]
    model = dt.ModelConfig(num_shards=g, factors_per_shard=K, rho=0.6)
    tpl = ck.carry_template(model, n=n, P=p // g, num_chains=C)
    rng = np.random.default_rng(C)
    assert jck.verify_checkpoint(donor)["crc_verified"]
    layouts = [tmesh.make_layout(RANKS, r, g, C) for r in range(RANKS)]
    assert layouts[0].rows == (2 if C == 2 else 1)
    with np.load(donor) as z:
        for i, name in enumerate(ck.state_leaf_names(model)):
            old = z[f"leaf_{i}"]
            fresh = rng.normal(size=tpl[name][0]).astype(np.float32)
            want = jres._graft_state_leaf(old, fresh)
            got = np.full_like(fresh, np.nan)
            for lay in layouts:
                view = object.__new__(shard.RankMesh)
                view.layout = lay
                local = view.local_leaves({name: fresh})[name]
                block, origin, shape = shard.leaf_block(lay, name, local)
                assert shape == fresh.shape
                out = resume.graft_block(old, block, origin, shape)
                got[tuple(slice(o, o + s) for o, s in
                          zip(origin, out.shape))] = out
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_an_incompatible_donor_is_a_cold_start_on_every_rank(donor,
                                                             tmp_path):
    """A donor whose Lambda does not embed (12 columns a shard against
    18): a recorded cold start, the one-device fit's, no hang."""
    cfg = _cfg(G, mesh=RANKS, warm_start=WarmStart(donor),
               obs=str(tmp_path / "m"))
    Y = _data()[:50, :144]
    mesh = dt.fit(Y, cfg)
    (decision, reason), = _decisions(str(tmp_path / "m"))
    assert decision == "cold" and "feature width" in reason
    one = dt.fit(Y, dataclasses.replace(
        cfg, obs="off", backend=dataclasses.replace(cfg.backend,
                                                    mesh_devices=0)))
    np.testing.assert_allclose(mesh.sigma_blocks, one.sigma_blocks,
                               rtol=RTOL, atol=ATOL)


def test_one_rank_s_failed_graft_is_a_cold_start_on_every_rank(
        donor, tmp_path, monkeypatch):
    """Rank 0 alone cannot read the donor: the mesh's one decision is
    cold, so no rank runs a warm block beside a cold one - the fit is the
    one-device cold start's, within the band, and rank 0 records its own
    reason once."""
    def unreadable(*a, **kw):
        raise OSError("the donor's disk is gone")

    monkeypatch.setattr(resume, "_read_leaf", unreadable)
    obs = str(tmp_path / "m")
    mesh = _warm(donor, "appended rows", obs, RANKS)
    assert _decisions(obs) == [("cold",
                                "OSError: the donor's disk is gone")]
    one = _warm(donor, "appended rows", "off")      # cold on one device
    np.testing.assert_allclose(mesh.sigma_blocks, one.sigma_blocks,
                               rtol=RTOL, atol=ATOL)
