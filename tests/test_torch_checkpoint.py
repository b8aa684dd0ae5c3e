"""The port's checkpoint files against the JAX package's, on the CPU.

A port checkpoint is the JAX package's format v8: its
``verify_checkpoint`` accepts the file and its ``load_checkpoint``, given a
``jax.eval_shape`` template of the JAX carry, reads every leaf equal to
the port's carry - full and light files, one chain and two.  The port's
``data_fingerprint``, ``_leaf_crc``, ``accumulator_window`` and
``checkpoint_compatible`` agree with the JAX package's, and the port
refuses a JAX-written file by its missing stream key.  Durability: a save
that fails midway leaves the previous file intact, ``.bakK`` rotation, a
flipped byte raises ``CheckpointCorruptError``, ``scan_generations``.
"""

import dataclasses
import functools
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.runtime import fetch as jfetch  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.runtime import pipeline  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

# the JAX package's checkpoint tests' size
N, P_COLS, G, K = 40, 24, 2, 3


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


def _cfg(pkg, C=1, **run):
    run = dict(burnin=6, mcmc=8, thin=2, seed=0, num_chains=C,
               chunk_size=4) | run
    return pkg.FitConfig(
        model=pkg.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6),
        run=pkg.RunConfig(**run),
        backend=pkg.BackendConfig(sse_mode="gram"))


def _port_file(tmp_path, C, mode):
    """A finished port fit's checkpoint (the last save is the final
    state) and the fit's result."""
    path = str(tmp_path / f"port_{C}_{mode}.npz")
    cfg = dataclasses.replace(_cfg(dt, C), checkpoint_path=path,
                              checkpoint_mode=mode,
                              checkpoint_every_chunks=1)
    return path, dt.fit(_data(), cfg, device="cpu")


def _jax_template(C):
    m = dcfm_tpu.ModelConfig(num_shards=G, factors_per_shard=K, rho=0.6)
    init_fn = dcfm_tpu.api._local_fns(m, 4, C)[0]
    P = preprocess(_data(), G, seed=0).data.shape[2]
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((G, N, P), np.float32))


@pytest.mark.parametrize("C", [1, 2])
@pytest.mark.parametrize("mode", ["full", "light"])
def test_the_jax_package_reads_a_port_checkpoint_leaf_for_leaf(tmp_path, C,
                                                               mode):
    path, res = _port_file(tmp_path, C, mode)
    meta = jck.verify_checkpoint(path)
    assert meta["crc_verified"] and meta["version"] == 8
    assert meta["state_only"] == (mode == "light")
    assert meta["rng"] == ck.RNG_STREAMS and meta["iteration"] == 14
    carry, jmeta = jck.load_checkpoint(path, _jax_template(C))
    got = jax.tree.leaves(carry)
    st = res.state
    want = [st.Lambda, st.Z, st.X, st.ps, st.prior["delta"],
            st.prior["psijh"]]
    assert len(got) == 9
    for a, b in zip(got[:6], want, strict=True):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    iteration = np.asarray(got[7])
    assert iteration.dtype == np.int32
    assert iteration.shape == ((C,) if C > 1 else ())
    assert (iteration == 14).all()
    # the accumulator: the file's (full) or the JAX loader's zeros (light)
    acc = np.asarray(got[6])
    assert acc.shape[-3] == dt.models.state.num_padded_pairs(G)
    if mode == "light":
        assert not acc.any()
    else:
        assert np.isfinite(acc).all() and acc.any()
    health = np.asarray(got[8])
    assert health.shape == ((C,) if C > 1 else ()) + (G, 4)
    # and the port reads the same leaves back
    leaves, pmeta = ck.load_checkpoint(
        path, ck.carry_template(res.config.model, n=N,
                                P=res.preprocess.data.shape[2],
                                num_chains=C))
    assert sorted(leaves) == sorted(
        ck.LIGHT_LEAVES if mode == "light" else ck.FULL_LEAVES)
    for name, arr in zip(ck.FULL_LEAVES, got, strict=True):
        if name in leaves:
            np.testing.assert_array_equal(leaves[name], np.asarray(arr))


def test_fingerprint_and_leaf_crc_are_the_jax_packages():
    rng = np.random.default_rng(0)
    for shape in ((2, 40, 12), (3, 7, 5), (64, 500, 157)):
        data = rng.standard_normal(shape).astype(np.float32)
        assert ck.data_fingerprint(data) == jck.data_fingerprint(data)
    for a in (data, np.arange(7, dtype=np.int32), np.float32(3.5),
              np.zeros((0,), np.float32)):
        assert ck._leaf_crc(a) == jck._leaf_crc(a)


@pytest.mark.parametrize("total,burnin,thin,acc_start,C", [
    (14, 6, 2, 0, 1), (14, 6, 2, 0, 2), (14, 6, 2, 8, 3), (400, 200, 2, 200, 2),
    (400, 200, 2, 250, 2), (13, 0, 1, 13, 1), (7, 7, 1, 0, 2),
    (1000, 333, 3, 400, 4)])
def test_accumulator_window_is_the_jax_packages(total, burnin, thin,
                                                acc_start, C):
    for kw in ({}, {"chain_acc_starts": [acc_start] * C},
               {"chain_acc_starts": [0] + [acc_start] * (C - 1),
                "fold_draws": 5}):
        got = fetch.accumulator_window(total, burnin, thin, acc_start, C,
                                       **kw)
        want = jfetch.accumulator_window(total, burnin, thin, acc_start, C,
                                         **kw)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:], strict=True):
            assert np.float32(a).tobytes() == np.float32(b).tobytes()


def _meta(pkg_ck, cfg, iteration=14, fingerprint="f" * 16):
    meta = {"config": pkg_ck._config_to_json(cfg), "iteration": iteration,
            "fingerprint": fingerprint}
    if pkg_ck is ck:
        meta["rng"] = ck.RNG_STREAMS
    return meta


# each change beside the file: (what the run changes, {...} of the run)
@pytest.mark.parametrize("change", [
    {}, {"model": {"rho": 0.5}}, {"model": {"factors_per_shard": 2}},
    {"run": {"seed": 1}}, {"run": {"burnin": 4}}, {"run": {"thin": 1}},
    {"run": {"mcmc": 4}}, {"run": {"mcmc": 20}}, {"run": {"num_chains": 2}},
    {"run": {"chunk_size": 3}}, {"backend": {"compute_dtype": "bf16"}},
    {"backend": {"sse_mode": "resid"}}, {"fingerprint": "0" * 16}])
def test_checkpoint_compatible_refuses_what_the_jax_package_refuses(change):
    reasons = []
    for pkg, pkg_ck in ((dcfm_tpu, jck), (dt, ck)):
        saved = _cfg(pkg)
        run = _cfg(pkg)
        run = dataclasses.replace(
            run,
            model=dataclasses.replace(run.model, **change.get("model", {})),
            run=dataclasses.replace(run.run, **change.get("run", {})),
            backend=dataclasses.replace(run.backend,
                                        **change.get("backend", {})))
        reasons.append(pkg_ck.checkpoint_compatible(
            _meta(pkg_ck, saved), run, change.get("fingerprint", "f" * 16)))
    assert (reasons[0] is None) == (reasons[1] is None), reasons


def _jax_written_file(tmp_path):
    """A checkpoint the JAX package wrote, of the port test's shapes."""
    tpl = _jax_template(1)
    carry = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tpl)
    data = preprocess(_data(), G, seed=0).data
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, carry, _cfg(dcfm_tpu),
                        fingerprint=jck.data_fingerprint(data))
    return path


def test_the_port_refuses_a_jax_written_checkpoint(tmp_path):
    """Its chain came from threefry keys: no 'rng' key, no resume - and
    resume='auto' starts fresh instead."""
    path = _jax_written_file(tmp_path)
    assert "rng" not in ck.read_checkpoint_meta(path)
    cfg = dataclasses.replace(_cfg(dt), checkpoint_path=path, resume=True)
    with pytest.raises(ValueError, match="torch-philox"):
        dt.fit(_data(), cfg, device="cpu")
    fresh = dt.fit(_data(), _cfg(dt), device="cpu")
    auto = dt.fit(_data(), dataclasses.replace(cfg, resume="auto"),
                  device="cpu")
    np.testing.assert_array_equal(auto.Sigma, fresh.Sigma)


# ---- durability -----------------------------------------------------------

def _leaves(seed=0, C=1):
    r = np.random.default_rng(seed)
    tpl = ck.carry_template(_cfg(dt).model, n=5, P=4, num_chains=C)
    return {k: (np.full(s, 7 + seed, dt_) if k == "iteration"
                else r.standard_normal(s).astype(dt_))
            for k, (s, dt_) in tpl.items()}, tpl


def test_a_save_that_fails_midway_leaves_the_previous_file(tmp_path,
                                                          monkeypatch):
    path = str(tmp_path / "ck.npz")
    leaves, tpl = _leaves(0)
    ck.save_checkpoint(path, leaves, _cfg(dt), fingerprint="a")
    before = open(path, "rb").read()

    def torn(f, **payload):
        f.write(b"PK\x03\x04 half a file")
        raise OSError("disk full")

    monkeypatch.setattr(ck.np, "savez", torn)
    with pytest.raises(OSError, match="disk full"):
        ck.save_checkpoint(path, _leaves(1)[0], _cfg(dt), fingerprint="a")
    monkeypatch.undo()
    assert open(path, "rb").read() == before
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []
    got, meta = ck.load_checkpoint(path, tpl)
    assert ck.verify_checkpoint(path)["iteration"] == 7
    for k in leaves:
        np.testing.assert_array_equal(got[k], leaves[k])


def test_keep_last_rotates_generations_and_scan_reads_them(tmp_path):
    path = str(tmp_path / "ck.npz")
    for i in range(4):
        ck.save_checkpoint(path, _leaves(i)[0], _cfg(dt), fingerprint="a",
                           keep_last=3)
    assert ck.retained_checkpoints(path) == [
        path, ck.retained_path(path, 1), ck.retained_path(path, 2)]
    assert [(p, it, e) for p, it, e in ck.scan_generations(path)] == [
        (path, 10, None), (ck.retained_path(path, 1), 9, None),
        (ck.retained_path(path, 2), 8, None)]
    # a hole in the chain hides nothing older; the JAX walk agrees
    os.unlink(ck.retained_path(path, 1))
    assert ck.retained_checkpoints(path) == jck.retained_checkpoints(path)
    assert [it for _, it, _ in ck.scan_generations(path)] == [10, 8]


def _flip_on_disk(path):
    """Flip one bit inside the largest leaf's bytes (sigma_acc, leaf_6)
    in the file: a media error after the write."""
    raw = bytearray(open(path, "rb").read())
    with np.load(path) as z:
        big = z["leaf_6"].tobytes()
    raw[bytes(raw).index(big[:64]) + 17] ^= 1
    open(path, "wb").write(bytes(raw))


@pytest.mark.parametrize("where", ["payload", "disk"])
def test_a_flipped_byte_raises_checkpoint_corrupt(tmp_path, monkeypatch,
                                                  where):
    """A bit flipped after the leaf CRCs were computed (the JAX package's
    bit_flip fault: the zip member is consistent, the leaf CRC is not), or
    on disk after the write (the zip member's CRC fails first): both are
    CheckpointCorruptError, in verify, load and the generation scan."""
    path = str(tmp_path / "ck.npz")
    leaves, tpl = _leaves(0)
    if where == "payload":
        savez = np.savez

        def flipping(f, **payload):
            a = np.array(payload["leaf_6"], copy=True)
            a.view(np.uint8).reshape(-1)[5] ^= 1
            return savez(f, **(payload | {"leaf_6": a}))

        monkeypatch.setattr(ck.np, "savez", flipping)
    ck.save_checkpoint(path, leaves, _cfg(dt), fingerprint="a")
    monkeypatch.undo()
    if where == "disk":
        _flip_on_disk(path)
    with pytest.raises(ck.CheckpointCorruptError) as e:
        ck.verify_checkpoint(path)
    assert e.value.path == path
    with pytest.raises(ck.CheckpointCorruptError):
        ck.load_checkpoint(path, tpl)
    if where == "payload":
        with pytest.raises(jck.CheckpointCorruptError):
            jck.verify_checkpoint(path)
    [(p, it, err)] = ck.scan_generations(path)
    assert it == -1 and isinstance(err, ck.CheckpointCorruptError)


def test_a_resumed_fit_refuses_a_corrupt_file_and_auto_starts_fresh(
        tmp_path):
    path, res = _port_file(tmp_path, 1, "full")
    _flip_on_disk(path)
    cfg = dataclasses.replace(res.config, resume=True,
                              run=dataclasses.replace(res.config.run,
                                                      mcmc=12))
    with pytest.raises(ck.CheckpointCorruptError):
        dt.fit(_data(), cfg, device="cpu")
    fresh = dt.fit(_data(), dataclasses.replace(cfg, checkpoint_path=None,
                                                resume=False), device="cpu")
    auto = dt.fit(_data(), dataclasses.replace(cfg, resume="auto"),
                  device="cpu")
    np.testing.assert_array_equal(auto.Sigma, fresh.Sigma)


def test_snapshot_leaves_follow_the_chain_axis_convention():
    """One chain: no chain axis, a scalar iteration; more: a leading axis
    (the JAX vmap's), chain c at index c."""
    cfg = _cfg(dt, 3)
    m = dataclasses.replace(cfg.model, sse_mode="gram")
    Yd = torch.as_tensor(preprocess(_data(), G, seed=0).data)
    runner = dt.models.sampler.ChainRunner(
        dt.noise.TorchNoise(0, "cpu"), Yd, m,
        dt.models.priors.make_prior(m), burnin=6, thin=2)
    carries = [runner.new_chain(c) for c in range(3)]
    for c, carry in enumerate(carries):
        runner.run_chunk(c, carry, 3 + c)
    for C in (1, 3):
        snap = ck.Snapshot(carries[:C], state_only=False).wait()
        tpl = ck.carry_template(m, n=N, P=Yd.shape[2], num_chains=C)
        assert {k: (v.shape, v.dtype) for k, v in snap.items()} == tpl
        for c in range(C):
            one = {k: (v[c] if C > 1 else v) for k, v in snap.items()}
            assert int(one["iteration"]) == 3 + c
            np.testing.assert_array_equal(one["psijh"],
                                          carries[c].state.prior["psijh"])
            np.testing.assert_array_equal(one["sigma_acc"],
                                          carries[c].sigma_acc)
    light = ck.Snapshot(carries, state_only=True).wait()
    assert sorted(light) == sorted(ck.LIGHT_LEAVES)
    assert pipeline.carries_from_leaves(light, 3, "cpu", (3, 1, 1))[2] \
        .sigma_acc.abs().sum() == 0


# ---- fault C7: the config in a port file, read by the JAX package ----------

def _field_pairs(port_obj, jax_obj, prefix=""):
    """(name, port value, JAX value) for every field of the port's
    dataclass, recursing into nested configs."""
    out = []
    for f in dataclasses.fields(port_obj):
        a, b = getattr(port_obj, f.name), getattr(jax_obj, f.name)
        if dataclasses.is_dataclass(a):
            out += _field_pairs(a, b, f"{prefix}{f.name}.")
        else:
            out.append((prefix + f.name, a, b))
    return out


def test_the_jax_package_reads_the_config_of_a_port_checkpoint(tmp_path):
    """Fault C7: the port wrote dataclasses.asdict of its own FitConfig,
    which lacks keys the JAX package's reader requires (model.horseshoe,
    .dl, .adapt; backend.backend, .profile_dir; obs; run.ess_target,
    .rhat_threshold), so config_from_checkpoint_meta raised KeyError on
    every port file.  Now it returns, field for field, the config the port
    ran - except elastic and materialize_sigma, which the JAX package's
    reader never reads back (its defaults come back; the file holds the
    port's values)."""
    path = str(tmp_path / "c7.npz")
    cfg = dataclasses.replace(
        _cfg(dt, 2), checkpoint_path=path, checkpoint_every_chunks=2,
        checkpoint_mode="light", checkpoint_full_every=2,
        checkpoint_keep_last=2, sentinel="abort", elastic=True,
        materialize_sigma="never",
        model=dataclasses.replace(_cfg(dt).model, lambda_kernel="pallas",
                                  ridge_jitter=0.5, x_prior_precision=2.0),
        backend=dt.BackendConfig(sse_mode="gram", fetch_dtype="quant8",
                                 upload_dtype="bfloat16"))
    dt.fit(_data(), cfg, device="cpu")
    meta = jck.read_checkpoint_meta(path)
    got = jck.config_from_checkpoint_meta(meta)
    assert isinstance(got, dcfm_tpu.FitConfig)
    unread = {"elastic", "materialize_sigma"}
    for name, a, b in _field_pairs(cfg, got):
        if name in unread:
            assert b == getattr(dcfm_tpu.FitConfig(
                model=got.model, run=got.run), name), name
            assert meta["config"][name] == a, name
        else:
            assert a == b, (name, a, b)
    # every key the JAX package writes, in its nesting and at its
    # defaults where the port has no field; nothing the JAX package lacks
    want = jck._config_to_json(got)
    have = meta["config"]
    assert list(have) == list(want)
    for section in ("model", "run", "backend"):
        assert list(have[section]) == list(want[section]), section
    for section, key in (("model", "horseshoe"), ("model", "dl"),
                         ("model", "adapt"), ("run", "rhat_threshold"),
                         ("run", "ess_target"), ("backend", "backend"),
                         ("backend", "profile_dir")):
        assert have[section][key] == want[section][key]
    assert have["obs"] == dcfm_tpu.FitConfig(model=got.model,
                                             run=got.run).obs
    # and the port reads both its own files and the JAX package's layout
    assert ck.config_from_checkpoint_meta(meta) == cfg
    legacy = dict(meta["config"])
    legacy["model"] = {k: v for k, v in legacy["model"].items()
                       if k not in ("horseshoe", "dl", "adapt")}
    legacy["run"] = {k: v for k, v in legacy["run"].items()
                     if k not in ("rhat_threshold", "ess_target")}
    legacy["backend"] = {k: v for k, v in legacy["backend"].items()
                         if k not in ("backend", "profile_dir")}
    legacy.pop("obs")
    assert ck._config_from_json(legacy) == cfg


def test_the_jax_package_continues_a_port_checkpoint_on_its_own_keys(
        tmp_path):
    """What fixing C7 changes on the JAX side (pinned, not endorsed): the
    JAX package never reads the port's "rng" key, so with the config
    readable its own gates (config, seed, schedule, fingerprint) accept a
    port file, and dcfm_tpu.fit(resume="auto") continues the port's chain
    from the file's iteration on threefry keys - a valid chain, bitwise
    equal to neither a fresh JAX fit nor the port's uninterrupted one.
    The port itself keeps refusing a JAX file for continuation."""
    path = str(tmp_path / "port.npz")
    short = dataclasses.replace(_cfg(dt, 2, mcmc=2), checkpoint_path=path)
    dt.fit(_data(), short, device="cpu")
    assert jck.read_checkpoint_meta(path)["iteration"] == 8
    strict = str(tmp_path / "strict.npz")
    shutil.copy(path, strict)
    jcfg = dataclasses.replace(_cfg(dcfm_tpu, 2), checkpoint_path=path,
                               resume="auto")
    cont = dcfm_tpu.fit(_data(), jcfg)
    assert cont.traces.shape[:2] == (2, 14 - 8)       # continued at 8
    fresh = dcfm_tpu.fit(_data(), _cfg(dcfm_tpu, 2))
    assert fresh.traces.shape[:2] == (2, 14)
    assert not np.array_equal(cont.Sigma, fresh.Sigma)
    port_full = dt.fit(_data(), _cfg(dt, 2), device="cpu")
    assert not np.array_equal(cont.Sigma, port_full.Sigma)
    # resume=True is no refusal either: the same continuation
    again = dcfm_tpu.fit(_data(), dataclasses.replace(
        jcfg, checkpoint_path=strict, resume=True))
    assert again.traces.shape[:2] == (2, 14 - 8)
    np.testing.assert_array_equal(again.Sigma, cont.Sigma)
    assert np.isfinite(cont.Sigma).all()
