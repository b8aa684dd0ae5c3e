"""The port's serve artifact against the JAX package's, on the CPU.

The same panels and preprocess maps written by both packages give the
same panel bytes, maps and metadata; an artifact the port exports opens
under ``dcfm_tpu.serve.artifact.PosteriorArtifact`` and answers
``assemble()`` and ``verify_panel`` as the port's own does (and the other
way round); ``FitResult.sigma_block`` is the JAX formula on the same
panels.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu.api as japi  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils import preprocess as jpre  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu  # noqa: E402
import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models.state import num_upper_pairs  # noqa: E402
from dcfm_tpu_torch.runtime.fetch import cast_for_link  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import preprocess as tpre  # noqa: E402

PROVENANCE = {"source": "fit", "num_shards": 4, "factors_per_shard": 2,
              "prior": "mgp", "estimator": "scaled", "seed": 0,
              "total_iters": 30}


def _y():
    rng = np.random.default_rng(7)
    Y = (rng.standard_normal((25, 26))
         * np.logspace(-1, 1, 26)).astype(np.float32)
    Y[:, 3] = 0.0
    return Y


def _q8(g, P, seed=1):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((num_upper_pairs(g), P, P)).astype(np.float32)
    u[1] = 0.0
    return u, tart.quantize_panels(u)


def test_quantize_panels_is_the_link_cast_and_the_jax_twin():
    u, (q, s) = _q8(4, 7)
    jq, js = jart.quantize_panels(u)
    lq, ls = cast_for_link(torch.from_numpy(u.copy()), "quant8")
    for a, b in ((q, jq), (s, js), (q, lq.numpy()), (s, ls.numpy())):
        np.testing.assert_array_equal(a, b)


def test_write_artifact_matches_jax_byte_for_byte(tmp_path):
    """Same panels and maps: byte-identical mean_q8.bin, identical
    maps.npz arrays, the same meta.json (fingerprint included)."""
    Y, g = _y(), 4
    a, b = tpre.preprocess(Y, g, seed=2), jpre.preprocess(Y, g, seed=2)
    _, (q, s) = _q8(g, a.shard_size)
    pa, pb = str(tmp_path / "port"), str(tmp_path / "jax")
    tart.write_artifact(pa, mean_q8=q, mean_scale=s, pre=a,
                        provenance=PROVENANCE)
    jart.write_artifact(pb, mean_q8=q, mean_scale=s, pre=b,
                        provenance=PROVENANCE)
    with open(os.path.join(pa, tart.MEAN_PANELS_FILE), "rb") as f1, \
            open(os.path.join(pb, jart.MEAN_PANELS_FILE), "rb") as f2:
        assert f1.read() == f2.read()
    with np.load(os.path.join(pa, tart.MAPS_FILE)) as za, \
            np.load(os.path.join(pb, jart.MAPS_FILE)) as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            assert za[k].dtype == zb[k].dtype
            np.testing.assert_array_equal(za[k], zb[k])
    with open(os.path.join(pa, tart.META_FILE)) as f1, \
            open(os.path.join(pb, jart.META_FILE)) as f2:
        ma, mb = json.load(f1), json.load(f2)
    assert ma == mb and ma["fingerprint"] == jart.artifact_fingerprint(mb)
    # and each package opens the other's artifact to the same answers
    np.testing.assert_array_equal(tart.PosteriorArtifact.open(pb).assemble(),
                                  jart.PosteriorArtifact.open(pa).assemble())


def _fit(fetch_dtype="quant8", materialize_sigma="auto"):
    Y, _ = make_synthetic(40, 26, 2, seed=4)
    Y[:, 3] = 0.0
    return dt.fit(Y, dt.FitConfig(
        model=dt.ModelConfig(num_shards=4, factors_per_shard=2, rho=0.8),
        run=dt.RunConfig(burnin=10, mcmc=20, num_chains=2),
        backend=dt.BackendConfig(fetch_dtype=fetch_dtype),
        materialize_sigma=materialize_sigma), device="cpu")


def test_port_export_opens_under_jax_and_answers_the_same(tmp_path):
    """Round trip: the JAX PosteriorArtifact opens the port's export and
    assembles the port's own answer - res.Sigma, bit for bit, under
    quant8 - and verifies every panel; a flipped byte fails the same
    panel in both."""
    res = _fit()
    path = str(tmp_path / "art")
    art = res.export_artifact(path)
    jopen = jart.PosteriorArtifact.open(path)
    assert jopen.fingerprint == art.fingerprint
    np.testing.assert_array_equal(art.assemble(), res.Sigma)
    np.testing.assert_array_equal(jopen.assemble(), res.Sigma)
    for pair in range(art.n_pairs):
        art.verify_panel("mean", pair)
        jopen.verify_panel("mean", pair)
    with open(os.path.join(path, tart.MEAN_PANELS_FILE), "r+b") as f:
        f.seek(art.P * art.P * 2 + 5)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0x40]))
    for opened, err in ((tart.PosteriorArtifact.open(path),
                         tart.ArtifactCorruptError),
                        (jart.PosteriorArtifact.open(path),
                         jart.ArtifactCorruptError)):
        opened.verify_panel("mean", 1)
        with pytest.raises(err) as e:
            opened.verify_panel("mean", 2)
        assert e.value.panel == 2


def test_float32_fit_exports_the_quant8_fits_bytes(tmp_path):
    """The same chain fetched at float32 (quantized on the host) and at
    quant8 (quantized on the device) exports the same artifact; without
    Sigma the export is the same too."""
    a = _fit("float32").export_artifact(str(tmp_path / "f32"))
    b = _fit("quant8", "never").export_artifact(str(tmp_path / "q8"))
    np.testing.assert_array_equal(np.asarray(a.mean_panels),
                                  np.asarray(b.mean_panels))
    np.testing.assert_array_equal(a.mean_scale, b.mean_scale)
    assert a.meta == b.meta


def test_open_refuses_a_torn_or_foreign_artifact(tmp_path):
    path = str(tmp_path / "art")
    _fit().export_artifact(path)
    os.unlink(os.path.join(path, tart.META_FILE))
    with pytest.raises(tart.ArtifactError, match="not a posterior artifact"):
        tart.PosteriorArtifact.open(path)
    _fit().export_artifact(path)
    with open(os.path.join(path, tart.MEAN_PANELS_FILE), "ab") as f:
        f.write(b"\0")
    with pytest.raises(tart.ArtifactError, match="truncated or mismatched"):
        tart.PosteriorArtifact.open(path)


@pytest.mark.parametrize("destandardize", [True, False])
def test_sigma_block_is_the_jax_formula(destandardize):
    """FitResult.sigma_block on the same panels and preprocess maps: the
    JAX package's block, every shard pair (transposes and diagonals)."""
    Y, g = _y(), 4
    a, b = tpre.preprocess(Y, g, seed=3), jpre.preprocess(Y, g, seed=3)
    u, _ = _q8(g, a.shard_size, seed=5)
    port = dt.FitResult(
        Sigma=None, preprocess=a, state=None, stats=None,
        config=dt.FitConfig(model=dt.ModelConfig(num_shards=g,
                                                 factors_per_shard=2,
                                                 rho=0.5),
                            run=dt.RunConfig(burnin=1, mcmc=1)),
        device="cpu", seconds=0.0, iters_per_sec=0.0,
        chain_iters_per_sec=0.0, traces=None, diagnostics={},
        chunk_seconds=[], phase_seconds={}, kernel_launches={}, graphs={},
        _upper_f32=u)
    jax_res = japi.FitResult(
        Sigma=None, preprocess=b, state=None, stats=None,
        config=dcfm_tpu.FitConfig(
            model=dcfm_tpu.ModelConfig(num_shards=g, factors_per_shard=2,
                                       rho=0.5),
            run=dcfm_tpu.RunConfig(burnin=1, mcmc=1)),
        seconds=0.0, iters_per_sec=0.0, _upper_f32=u)
    for i in range(g):
        for j in range(g):
            np.testing.assert_array_equal(
                port.sigma_block(i, j, destandardize=destandardize),
                jax_res.sigma_block(i, j, destandardize=destandardize))
