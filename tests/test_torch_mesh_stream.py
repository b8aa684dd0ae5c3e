"""The shard mesh's streamed quant8 fetch (dcfm_tpu_torch/runtime/pipeline.
StreamingFetcher on parallel/shard.RankMesh), on 4 gloo ranks of the CPU.

Under ``fetch_dtype="quant8"`` a mesh fit streams its fetch under
``fetch_stream`` "auto" and "on", as the JAX package's one-process mesh
does: at each boundary every rank sums its chains into the streamer's own
buffers, the slices are pooled over the chain rows, quantized per pair
slice and gathered to rank 0, whose drain thread lands them.  The final
snapshot is the post-hoc mesh fetch's computation on the same sums, so
the int8 panels, scales, Sigma and SD are bitwise the ``"off"`` fit's, on a
packed grid and with every chain on every rank; ``stream_artifact`` lands
the post-hoc export byte for byte; a skipped boundary stays bitwise; a
stream that fails raises instead of falling back, and leaves the artifact
unopenable.  A 1-rank world is the one-device streamed fit bit for bit.
"""

import dataclasses
import functools
import time
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch import api  # noqa: E402
from dcfm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.test_torch_export import _same_artifact  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402

G, N, P_COLS, RANKS = 8, 50, 96, 4


@pytest.fixture(autouse=True)
def _bounded():
    with deadline(180):
        yield


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 3, seed=4)
    return Y


def _cfg(stream, C=2, sd=False, mesh=RANKS, pkg=dt, **kw):
    backend = dict(fetch_dtype="quant8", fetch_stream=stream,
                   mesh_devices=mesh, sse_mode="gram")
    if pkg is dt:
        backend["backend"] = "torch_cpu"
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=3, rho=0.8,
                              posterior_sd=sd),
        run=pkg.RunConfig(burnin=6, mcmc=8, thin=2, seed=2, num_chains=C,
                          chunk_size=4),
        backend=pkg.BackendConfig(**backend), **kw)


@functools.lru_cache(maxsize=None)
def _fit(stream, C=2, sd=False, mesh=RANKS):
    return dt.fit(_data(), _cfg(stream, C, sd, mesh))


def _one_rank(cfg):
    with mock.patch.object(api, "_fit", functools.partial(
            api._fit, one_rank_mesh=True)):
        return dt.fit(_data(), cfg)


def _bitwise(a, b, sd):
    np.testing.assert_array_equal(a._q8_panels, b._q8_panels)
    np.testing.assert_array_equal(a._q8_scales, b._q8_scales)
    np.testing.assert_array_equal(a.Sigma, b.Sigma)
    if sd:
        np.testing.assert_array_equal(a._sd_q8_panels, b._sd_q8_panels)
        np.testing.assert_array_equal(a._sd_q8_scales, b._sd_q8_scales)
        np.testing.assert_array_equal(a.Sigma_sd, b.Sigma_sd)


@pytest.mark.parametrize("C,sd", [(2, True), (3, False)])
def test_the_mesh_streams_its_post_hoc_fetch_bit_for_bit(tmp_path, C, sd):
    """C = 2 packs one chain a row of 2 ranks, 3 chains run on every
    rank: "on" (landing in the serve artifact) and "auto" both stream, and
    both are the "off" fit's panels, scales, Sigma and SD; the artifact is
    the post-hoc export of the "off" fit byte for byte."""
    assert tmesh.make_layout(RANKS, 0, G, C).rows == (2 if C == 2 else 1)
    art = str(tmp_path / "stream")
    on = dt.fit(_data(), _cfg("on", C, sd, stream_artifact=art))
    auto, off = _fit("auto", C, sd), _fit("off", C, sd)
    assert off.stream_stats is None
    for res in (on, auto):
        st = res.stream_stats
        # boundaries at 4 (burn-in: nothing saved yet), 8, 12 and 14
        assert st["streamed"] and st["snapshots"] == 3 and not st["skipped"]
        _bitwise(res, off, sd)
    assert on.artifact_path == art
    off.export_artifact(str(tmp_path / "post"))
    _same_artifact(art, str(tmp_path / "post"), sd)
    np.testing.assert_array_equal(
        tart.PosteriorArtifact.open(art).assemble(), off.Sigma)


def test_the_snapshots_are_the_jax_package_s_one_process_mesh_s():
    """The JAX package streams its one-process mesh (``mesh_devices=2`` on
    the virtual CPU devices) at the same boundaries: the same snapshot
    count as the port's 4-rank mesh and its one device."""
    jx = dcfm_tpu.fit(_data(), _cfg("auto", 2, True, mesh=2, pkg=dcfm_tpu))
    assert jx.stream_stats is not None
    assert (_fit("auto", 2, True).stream_stats["snapshots"]
            == jx.stream_stats["snapshots"]
            == _fit("auto", 2, True, mesh=0).stream_stats["snapshots"])
    assert not jx.stream_stats["skipped"]


def test_a_one_rank_world_is_the_one_device_streamed_fit(tmp_path):
    """The mesh's rank program as a world of one rank, streaming into an
    artifact: the one-device streamed fit (and its post-hoc twin) bit for
    bit, with the same telemetry counts and the same artifact bytes."""
    one_art, art = str(tmp_path / "one"), str(tmp_path / "rank")
    one = dt.fit(_data(), _cfg("on", 2, True, mesh=0,
                               stream_artifact=one_art))
    ranked = _one_rank(_cfg("on", 2, True, mesh=0, stream_artifact=art))
    for res in (ranked, one):
        _bitwise(res, _fit("off", 2, True, mesh=0), True)
    for k in ("snapshots", "skipped"):
        assert ranked.stream_stats[k] == one.stream_stats[k]
    _same_artifact(art, one_art, True)


def test_a_skipped_boundary_is_one_decision_and_stays_bitwise(monkeypatch):
    """Rank 0's drain slowed (the JAX package's forced skip): both of its
    slots are busy at a boundary, and its decision to skip is every
    rank's - no mismatched gather, no hang - and the panels stay the post-
    hoc ones."""
    real = pipeline.quant8_drain

    def slow(started):
        time.sleep(0.3)
        return real(started)

    monkeypatch.setattr(pipeline, "quant8_drain", slow)
    cfg = _cfg("on", 2, True)
    res = dt.fit(_data(), dataclasses.replace(
        cfg, run=dataclasses.replace(cfg.run, chunk_size=1)))
    st = res.stream_stats
    # chunks of 1: the boundaries 8 .. 14 follow the first saved draw
    assert st["skipped"] >= 1 and st["snapshots"] + st["skipped"] == 7
    _bitwise(res, _fit("off", 2, True), True)


def test_a_failed_mesh_stream_raises_and_leaves_no_artifact(tmp_path,
                                                            monkeypatch):
    """A drain that fails on rank 0 fails the mesh fit - it never turns
    into a post-hoc fetch, which is collective - and the artifact it was
    landing in stays without its meta.json, refusing to open."""
    def broken(started):
        raise OSError("the landing disk is gone")

    monkeypatch.setattr(pipeline, "quant8_drain", broken)
    art = str(tmp_path / "stream")
    with pytest.raises((RuntimeError, OSError)):
        dt.fit(_data(), _cfg("on", 2, stream_artifact=art))
    with pytest.raises(tart.ArtifactError, match="no meta.json"):
        tart.PosteriorArtifact.open(art)
