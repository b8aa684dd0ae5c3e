"""Elastic resumes that GROW the chain count on the shard mesh
(dcfm_tpu_torch/runtime/pipeline.run_chain's births), on 4 gloo ranks of
the CPU.

A 2-chain file saved at the burn-in boundary is adopted at 4 chains: the
adoption is decided from the one file on every rank, the file's global
leaves are scattered under the NEW layout (4 chains on 4 ranks: a packed
grid, one chain a rank), and each rank draws its block of each birth from
``runner.new_chain(c, elastic_lineage)`` - the slice of the one-device
birth (noise.ShardSliceNoise).  The bookkeeping is the one-device grow's
(the JAX package's corner, tests/test_elastic.py:216), Sigma is within
the JAX package's mesh band of it, and a 1-rank world is it bit for bit.
A grow to 3 chains does not divide the 4 ranks: it takes the fallback,
every chain on every rank, each birth split over the shard blocks.
"""

import dataclasses
import functools
import shutil
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.parallel.mesh import legal_chain_grid as j_legal  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import api  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402

G, RANKS, BURNIN, MCMC = 8, 4, 6, 8
RTOL, ATOL = 1e-3, 1e-4       # tests/test_shard.py's mesh-parity band


@pytest.fixture(autouse=True)
def _bounded():
    with deadline(180):
        yield


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(50, 96, 3, seed=5)
    return Y


def _cfg(C=2, mesh=0, **run):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=G, factors_per_shard=3, rho=0.6),
        run=dt.RunConfig(**({"burnin": BURNIN, "mcmc": MCMC, "thin": 2,
                             "seed": 4, "num_chains": C, "chunk_size": 4}
                            | run)),
        backend=dt.BackendConfig(backend="torch_cpu", sse_mode="gram",
                                 mesh_devices=mesh))


@pytest.fixture(scope="module")
def at_burnin(tmp_path_factory):
    """A 2-chain file saved at the burn-in boundary (iteration 6): the
    whole schedule of a fit with no kept iterations."""
    path = str(tmp_path_factory.mktemp("grow") / "burnin.npz")
    with deadline(120):
        dt.fit(_data(), dataclasses.replace(_cfg(mcmc=0),
                                            checkpoint_path=path))
    assert ck.read_checkpoint_meta(path)["iteration"] == BURNIN
    return path


def _grow(src, tmp_path, name, C, ranks=0):
    """``src`` copied and resumed at ``C`` chains on one device, on
    ``ranks`` > 1 gloo ranks, or with ``ranks`` = 1 as the mesh's rank
    program in a world of one rank."""
    path = str(tmp_path / f"{name}.npz")
    shutil.copy(src, path)
    cfg = dataclasses.replace(_cfg(C, ranks if ranks > 1 else 0),
                              checkpoint_path=path, resume=True,
                              checkpoint_every_chunks=1)
    if ranks != 1:
        return dt.fit(_data(), cfg), path
    with mock.patch.object(api, "_fit", functools.partial(
            api._fit, one_rank_mesh=True)):
        return dt.fit(_data(), cfg), path


def test_a_grow_on_the_mesh_is_the_one_device_grow(at_burnin,
                                                   tmp_path_factory):
    """2 -> 4 chains on 4 ranks: the JAX corner's bookkeeping (kept 2,
    dropped 0, birthed 2, the births' windows at the adoption, lineage 1,
    nothing folded), the one-device grow's to the field, its file's
    elastic meta, and Sigma within the band."""
    tmp = tmp_path_factory.mktemp("g4")
    assert tmesh.make_layout(RANKS, 0, G, 4).rows == 4
    one, _ = _grow(at_burnin, tmp, "one", 4)
    mesh, path = _grow(at_burnin, tmp, "mesh", 4, RANKS)
    el = mesh.elastic_resume
    assert (el["from_chains"], el["to_chains"]) == (2, 4)
    assert (el["kept"], el["dropped"], el["birthed"]) == (2, 0, 2)
    assert list(el["chain_acc_starts"]) == [0, 0, BURNIN, BURNIN]
    assert el["elastic_lineage"] == 1 and el["fold_draws"] == 0
    assert el == one.elastic_resume
    meta = ck.read_checkpoint_meta(path)
    assert list(meta["chain_acc_starts"]) == [0, 0, BURNIN, BURNIN]
    assert meta["elastic_lineage"] == 1
    assert meta["topology"]["num_devices"] == RANKS
    np.testing.assert_allclose(mesh.sigma_blocks, one.sigma_blocks,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mesh.state.Lambda, one.state.Lambda,
                               rtol=RTOL, atol=ATOL)


def test_a_one_rank_world_s_grow_is_the_one_device_grow_bit_for_bit(
        at_burnin, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("g1")
    one, _ = _grow(at_burnin, tmp, "one", 4)
    ranked, _ = _grow(at_burnin, tmp, "ranked", 4, 1)
    assert ranked.elastic_resume == one.elastic_resume
    np.testing.assert_array_equal(ranked.Sigma, one.Sigma)
    for a, b in zip(sampler.state_leaves(ranked.state),
                    sampler.state_leaves(one.state), strict=True):
        assert torch.equal(a, b)


def test_a_grow_that_does_not_divide_takes_the_fallback_layout(
        at_burnin, tmp_path_factory):
    """2 -> 3 chains on 4 ranks: no packed grid (the JAX package's
    predicate says the same), so every rank runs the 3 chains on its 2
    shards and draws its block of the birth; the one-device grow within
    the band."""
    assert not tmesh.legal_chain_grid(3, RANKS, G)
    assert not j_legal(3, RANKS, G) and j_legal(4, RANKS, G)
    assert tmesh.make_layout(RANKS, 0, G, 3).rows == 1
    tmp = tmp_path_factory.mktemp("g3")
    one, _ = _grow(at_burnin, tmp, "one", 3)
    mesh, _ = _grow(at_burnin, tmp, "mesh", 3, RANKS)
    assert mesh.elastic_resume == one.elastic_resume
    assert mesh.elastic_resume["birthed"] == 1
    np.testing.assert_allclose(mesh.sigma_blocks, one.sigma_blocks,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(mesh.state.Lambda, one.state.Lambda,
                               rtol=RTOL, atol=ATOL)
