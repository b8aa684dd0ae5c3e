"""The port's artifact exports against the JAX package's, on the CPU:
``export_from_checkpoint`` and ``FitConfig.stream_artifact``.

An export from a checkpoint reads no random stream, so the JAX package's
``export_from_checkpoint`` is an exact oracle for the port's, on a file of
either package: mean panels and scales byte for byte, SD panels within
one quant step (C = 1, 2; a full file, and a light file read through its
``.full`` sidecar).  The port's export of its own finished full file is
also the fit's own ``export_artifact``.  A streamed artifact is the
post-hoc export byte for byte (panels, scales, maps, CRCs), opens in the
JAX package, survives a kill and resume, and falls back to the post-hoc
export when nothing landed.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402

N, P_COLS, G, K = 40, 24, 2, 3
PANELS = ("mean_q8.bin", "sd_q8.bin")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 2, seed=3)
    return Y


def _cfg(pkg, C=2, sd=True, backend=None, model=None, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6,
                              posterior_sd=sd, **(model or {})),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(**({"sse_mode": "gram"}
                                     | (backend or {}))))


def _port_files(tmp_path, C, sd, kind):
    """A finished port fit with checkpoints: ``kind`` "full" (every
    boundary) or "light" (light saves, the 3rd a full sidecar at 12), and the
    fit's result."""
    path = str(tmp_path / f"p_{C}_{sd}_{kind}.npz")
    extra = ({"checkpoint_mode": "light", "checkpoint_full_every": 3}
             if kind == "light" else {})
    cfg = dataclasses.replace(_cfg(dt, C, sd), checkpoint_path=path,
                              checkpoint_every_chunks=1, **extra)
    return path, dt.fit(_data(), cfg, device="cpu")


def _panels(art, kind):
    return np.asarray(art.panels(kind)[0]), np.asarray(art.panels(kind)[1])


def _same_mean(a, b):
    """Mean panels and scales byte for byte."""
    for x, y in zip(_panels(a, "mean"), _panels(b, "mean"), strict=True):
        assert x.tobytes() == y.tobytes()


def _sd_within_a_step(a, b):
    """SD panels within one int8 step (each dequantized entry within one
    scale/127 of the other's), scales within float32 rounding."""
    assert a.has_sd and b.has_sd
    (qa, sa), (qb, sb) = _panels(a, "sd"), _panels(b, "sd")
    np.testing.assert_allclose(sa, sb, rtol=2e-5, atol=0)
    da = qa.astype(np.float32) * (sa / 127)[:, None, None]
    db = qb.astype(np.float32) * (sb / 127)[:, None, None]
    step = np.maximum(sa, sb)[:, None, None] / 127
    assert (np.abs(da - db) <= step * (1 + 1e-5)).all()


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("kind", ["full", "light"])
@pytest.mark.parametrize("sd", [False, True])
def test_the_ports_export_of_a_port_file_is_the_jax_packages(tmp_path, C,
                                                             kind, sd):
    """The port's and the JAX package's export_from_checkpoint of the same
    port file (the light file through its .full sidecar): mean panels and
    scales byte for byte, SD within one quant step (measured: identical,
    both run the same NumPy arithmetic); the same maps; provenance names
    the file the panels came from."""
    path, res = _port_files(tmp_path, C, sd, kind)
    if kind == "light":
        assert ck.read_checkpoint_meta(path)["state_only"]
        assert os.path.exists(path + ".full")
    ours = tart.export_from_checkpoint(path, _data(), str(tmp_path / "t"))
    ref = jart.export_from_checkpoint(path, _data(), str(tmp_path / "j"))
    _same_mean(ours, ref)
    assert ours.has_sd == ref.has_sd == sd
    if sd:
        _sd_within_a_step(ours, ref)
    assert ours.meta["provenance"] == ref.meta["provenance"]
    assert ours.meta["provenance"]["checkpoint"].endswith(
        ".npz.full" if kind == "light" else ".npz")
    for a in ("perm", "inv_perm", "kept_cols", "col_scale", "col_mean"):
        np.testing.assert_array_equal(getattr(ours.pre, a),
                                      getattr(ref.pre, a))
    if kind == "full":
        # the finished full file holds the fit's own sums: its export is
        # the fit's own export_artifact
        own = res.export_artifact(str(tmp_path / "own"))
        _same_mean(ours, own)
        if sd:
            _sd_within_a_step(ours, own)


def test_the_ports_export_of_a_jax_written_file_is_the_jax_packages(
        tmp_path):
    """Export reads no random stream: a file the JAX package wrote (two
    chains, posterior_sd) exports in the port as in the JAX package."""
    path = str(tmp_path / "jax.npz")
    dcfm_tpu.fit(_data(), dataclasses.replace(
        _cfg(dcfm_tpu), checkpoint_path=path, checkpoint_every_chunks=1))
    assert "rng" not in ck.read_checkpoint_meta(path)
    ours = tart.export_from_checkpoint(path, _data(), str(tmp_path / "t"))
    ref = jart.export_from_checkpoint(path, _data(), str(tmp_path / "j"))
    _same_mean(ours, ref)
    _sd_within_a_step(ours, ref)
    np.testing.assert_array_equal(ours.assemble(), ref.assemble())


def test_export_refuses_what_the_jax_package_refuses(tmp_path):
    """A window with no saved draws, a light file without a sidecar and
    another data matrix: ArtifactError in both packages, no artifact."""
    Y = _data()
    burn = str(tmp_path / "burn.npz")
    dt.fit(Y, dataclasses.replace(_cfg(dt, mcmc=0), checkpoint_path=burn),
           device="cpu")
    light = str(tmp_path / "light.npz")
    dt.fit(Y, dataclasses.replace(_cfg(dt), checkpoint_path=light,
                                  checkpoint_mode="light"), device="cpu")
    full = str(tmp_path / "full.npz")
    dt.fit(Y, dataclasses.replace(_cfg(dt), checkpoint_path=full),
           device="cpu")
    other = Y.copy()
    other[0, 0] += 1.0
    for path, data, match in ((burn, Y, "no saved draws"),
                              (light, Y, "no .full sidecar"),
                              (full, other, "fingerprint mismatch")):
        for mod in (tart, jart):
            out = str(tmp_path / f"{mod.__name__}_{os.path.basename(path)}")
            with pytest.raises(mod.ArtifactError, match=match):
                mod.export_from_checkpoint(path, data, out)
            assert not os.path.exists(os.path.join(out, "meta.json"))


def test_export_refuses_a_config_the_port_cannot_represent(tmp_path):
    """A JAX-written file of a knob the port does not run (the shard mesh,
    ``mesh_devices``; the horseshoe prior, draw storage and the chunked
    combine this test used are ported, see tests/test_torch_adapt.py,
    tests/test_torch_draws.py and tests/test_torch_combine_chunks.py) is
    refused naming its Queue A item; a missing file is a
    FileNotFoundError."""
    path = str(tmp_path / "cc.npz")
    dcfm_tpu.fit(_data(), dataclasses.replace(
        _cfg(dcfm_tpu, sd=False, backend={"mesh_devices": 2}),
        checkpoint_path=path))
    with pytest.raises(NotImplementedError, match="Queue A item 4"):
        tart.export_from_checkpoint(path, _data(), str(tmp_path / "a"))
    with pytest.raises(FileNotFoundError):
        tart.export_from_checkpoint(str(tmp_path / "none.npz"), _data(),
                                    str(tmp_path / "b"))


# ---- stream_artifact ------------------------------------------------------

def _stream_cfg(path, sd=True, **kw):
    cfg = _cfg(dt, 2, sd, {"fetch_dtype": "quant8"})
    return dataclasses.replace(cfg, stream_artifact=path, **kw)


def _same_artifact(a_path, b_path, sd):
    """Panels, scales, maps and per-panel CRCs of two artifacts."""
    a, b = tart.PosteriorArtifact.open(a_path), tart.PosteriorArtifact.open(
        b_path)
    for name in PANELS[:1 + sd]:
        assert (open(os.path.join(a_path, name), "rb").read()
                == open(os.path.join(b_path, name), "rb").read()), name
    assert a.meta["panel_crc"] == b.meta["panel_crc"]
    for key in ("g", "P", "p_original", "n_pad", "has_sd"):
        assert a.meta[key] == b.meta[key], key
    with np.load(os.path.join(a_path, "maps.npz")) as x, \
            np.load(os.path.join(b_path, "maps.npz")) as y:
        assert sorted(x.files) == sorted(y.files)
        for k in x.files:
            assert x[k].tobytes() == y[k].tobytes(), k


@pytest.mark.parametrize("sd", [False, True])
def test_the_streamed_artifact_is_the_post_hoc_export(tmp_path, sd):
    """The stream's final drain lands in the artifact's memmaps; fit
    finalizes it.  It is the post-hoc export of the same chain (the fetch
    not streamed) byte for byte, the result's panels are the artifact's
    read-only maps, and export_artifact to the same path only opens it."""
    path = str(tmp_path / "stream")
    res = dt.fit(_data(), _stream_cfg(path, sd), device="cpu")
    assert res.artifact_path == path and res.stream_stats["snapshots"] == 3
    assert isinstance(res._q8_panels, np.memmap)
    assert not res._q8_panels.flags.writeable
    post = dt.fit(_data(), dataclasses.replace(
        _cfg(dt, 2, sd, {"fetch_dtype": "quant8", "fetch_stream": "off"})),
        device="cpu")
    post.export_artifact(str(tmp_path / "post"))
    _same_artifact(path, str(tmp_path / "post"), sd)
    np.testing.assert_array_equal(res.Sigma, post.Sigma)
    if sd:
        np.testing.assert_array_equal(res.Sigma_sd, post.Sigma_sd)
    mtime = os.path.getmtime(os.path.join(path, "meta.json"))
    again = res.export_artifact(path)
    assert os.path.getmtime(os.path.join(path, "meta.json")) == mtime
    assert again.fingerprint == tart.PosteriorArtifact.open(path).fingerprint
    assert res.export_artifact(str(tmp_path / "copy")).fingerprint \
        != again.fingerprint          # another provenance, same panels
    _same_artifact(path, str(tmp_path / "copy"), sd)


def test_the_jax_package_opens_a_streamed_artifact(tmp_path):
    path = str(tmp_path / "stream")
    res = dt.fit(_data(), _stream_cfg(path), device="cpu")
    jx = jart.PosteriorArtifact.open(path)
    assert jx.has_sd and jx.meta["provenance"]["source"] == "fit-stream"
    np.testing.assert_array_equal(jx.assemble(), res.Sigma)
    np.testing.assert_array_equal(jx.assemble(kind="sd"), res.Sigma_sd)
    for pair in range(jx.n_pairs):
        jx.verify_panel("mean", pair)
        jx.verify_panel("sd", pair)


def test_a_resumed_streamed_artifact_is_the_uninterrupted_one(tmp_path):
    """Killed after the save at iteration 8 (the artifact left without
    its meta.json: unopenable), resumed: the artifact is the uninterrupted
    fit's, byte for byte."""
    ref_path = str(tmp_path / "ref")
    dt.fit(_data(), _stream_cfg(ref_path), device="cpu")
    path, art = str(tmp_path / "s.npz"), str(tmp_path / "art")
    cfg = _stream_cfg(art, checkpoint_path=path, checkpoint_every_chunks=1)
    save = pipeline.save_checkpoint

    class Stop(BaseException):
        pass

    class Sync(pipeline.AsyncCheckpointWriter):
        def submit(self, save_fn, p, carries, c, *, fingerprint, **kw):
            leaves = ck.Snapshot(carries, state_only=False).wait()
            save(p, leaves, c, fingerprint=fingerprint, **kw)
            if int(np.asarray(leaves["iteration"]).reshape(-1)[0]) == 8:
                raise Stop()

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "AsyncCheckpointWriter", Sync)
        with pytest.raises(Stop):
            dt.fit(_data(), cfg, device="cpu")
    with pytest.raises(tart.ArtifactError, match="no meta.json"):
        tart.PosteriorArtifact.open(art)
    res = dt.fit(_data(), dataclasses.replace(cfg, resume=True),
                 device="cpu")
    assert res.stream_stats["snapshots"] == 2 and res.artifact_path == art
    _same_artifact(art, ref_path, True)


def test_when_nothing_lands_the_artifact_is_exported_post_hoc(tmp_path,
                                                             monkeypatch):
    """A finished file resumed as a no-op streams nothing, and a drain
    that fails (warned, as the JAX package warns) lands nothing: either
    way fit exports post hoc, and the artifact is the streamed one's."""
    ref_path = str(tmp_path / "ref")
    dt.fit(_data(), _stream_cfg(ref_path), device="cpu")
    path = str(tmp_path / "done.npz")
    dt.fit(_data(), _stream_cfg(str(tmp_path / "first"),
                                checkpoint_path=path), device="cpu")
    art = str(tmp_path / "noop")
    res = dt.fit(_data(), _stream_cfg(art, checkpoint_path=path,
                                      resume=True), device="cpu")
    assert res.traces.shape[1] == 0 and res.stream_stats is None
    assert res.artifact_path == art
    _same_artifact(art, ref_path, True)

    def failing(started):
        raise OSError("link lost")

    monkeypatch.setattr(pipeline, "quant8_drain", failing)
    art = str(tmp_path / "failed")
    with pytest.warns(RuntimeWarning, match="falling back to the post-hoc"):
        res = dt.fit(_data(), _stream_cfg(art), device="cpu")
    assert res.stream_stats is None and res.artifact_path == art
    _same_artifact(art, ref_path, True)


def test_a_new_stream_never_rewrites_an_earlier_results_panels(tmp_path):
    """begin_streamed_artifact removes meta.json first and lands in fresh
    inodes: a second fit streamed into the same directory leaves the first
    result's (memmapped) panels as they were."""
    path = str(tmp_path / "art")
    first = dt.fit(_data(), _stream_cfg(path), device="cpu")
    before = np.array(first._q8_panels, copy=True)
    sd_before = np.array(first._sd_q8_panels, copy=True)
    second = dt.fit(_data(), dataclasses.replace(
        _stream_cfg(path), run=dataclasses.replace(
            _stream_cfg(path).run, seed=1)), device="cpu")
    assert not np.array_equal(np.asarray(second._q8_panels), before)
    np.testing.assert_array_equal(np.asarray(first._q8_panels), before)
    np.testing.assert_array_equal(np.asarray(first._sd_q8_panels),
                                  sd_before)
    mean_mm, sd_mm = tart.begin_streamed_artifact(path, g=G, P=12,
                                                  has_sd=False)
    assert sd_mm is None and mean_mm.shape == (3, 12, 12)
    assert not os.path.exists(os.path.join(path, "meta.json"))
    assert not os.path.exists(os.path.join(path, "sd_q8.bin"))
    np.testing.assert_array_equal(np.asarray(first._q8_panels), before)
