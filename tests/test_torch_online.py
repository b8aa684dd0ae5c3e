"""The port's online fit->serve loop against the JAX package's.

``dcfm_tpu_torch.online`` composes the port's warm starts, supervisor,
streamed export and promotion exactly as ``dcfm_tpu.online`` does: the
same detections, plans and refit configs on the same manifests, the same
cycle events and generations for cold -> appended rows -> replaced, the
same typed refusals, a promotion root the JAX package opens (its
``assemble()`` bitwise the port's), a watcher state file the JAX watcher
reads, a shutdown-safe daemon loop, and a supervised refit that survives
a SIGKILL.  The port's refits run where their config's ``backend`` says:
the tests ask for the CPU through ``default_runner(settings,
"torch_cpu")``.
"""

import dataclasses
import json
import os
import shutil
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu.obs.recorder as jrec  # noqa: E402
import dcfm_tpu.online.cycle as jcy  # noqa: E402
import dcfm_tpu.online.watch as jwa  # noqa: E402
import dcfm_tpu.serve.artifact as jart  # noqa: E402
import dcfm_tpu.serve.promote as jpro  # noqa: E402
import dcfm_tpu.utils.checkpoint as jck  # noqa: E402
import dcfm_tpu.utils.preprocess as jpre  # noqa: E402
import dcfm_tpu_torch.obs.recorder as trec  # noqa: E402
import dcfm_tpu_torch.online.cycle as tcy  # noqa: E402
import dcfm_tpu_torch.online.watch as twa  # noqa: E402
import dcfm_tpu_torch.serve.artifact as tart  # noqa: E402
import dcfm_tpu_torch.serve.promote as tpro  # noqa: E402
import dcfm_tpu_torch.utils.checkpoint as tck  # noqa: E402
import dcfm_tpu_torch.utils.preprocess as tpre  # noqa: E402
from dcfm_tpu_torch.resilience import faults as tf  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the two packages' modules side by side: (cycle, watch, recorder,
# artifact, promote, checkpoint, preprocess)
JAX = (jcy, jwa, jrec, jart, jpro, jck, jpre)
PORT = (tcy, twa, trec, tart, tpro, tck, tpre)


def _settings(cy, tmp, **kw):
    base = dict(root=os.path.join(str(tmp), "root"),
                workdir=os.path.join(str(tmp), "watch"),
                factors_per_shard=3, rho=0.7, shard_width=12,
                burnin=20, mcmc=20, warm_burnin=5, seed=0,
                supervised=False, max_drift=10.0)
    base.update(kw)
    s = cy.CycleSettings(**base)
    os.makedirs(s.root, exist_ok=True)
    os.makedirs(s.workdir, exist_ok=True)
    return s


def _runner(mods, settings):
    """The cycle's refit: the JAX package's default (the CPU here), the
    port's on the CPU."""
    if mods is JAX:
        return None
    return tcy.default_runner(settings, "torch_cpu")


class _Events:
    """Capture one package's flight-recorder events into ``dir``."""

    def __init__(self, rec_mod, directory):
        self.mod, self.dir = rec_mod, directory

    def __enter__(self):
        self.rec = self.mod.FlightRecorder(self.dir, run_id="test")
        self.mod.install(self.rec)
        return self

    def __exit__(self, *exc):
        self.mod.uninstall(self.rec)
        self.rec.close()

    def events(self, prefixes=("online_", "delta_")):
        self.rec.flush()
        evs, _ = self.mod.run_events_with_stats(self.dir)
        return [e for e in evs if str(e.get("event")).startswith(prefixes)]


def _data():
    rng = np.random.default_rng(11)
    L = rng.normal(size=(24, 3))
    Y0 = (rng.normal(size=(40, 3)) @ L.T
          + 0.5 * rng.normal(size=(40, 24))).astype(np.float32)
    Y1 = np.vstack([Y0, (rng.normal(size=(10, 3)) @ L.T + 0.5 * rng.normal(
        size=(10, 24))).astype(np.float32)])
    Y2 = (rng.normal(size=(50, 3)) @ L.T
          + 0.5 * rng.normal(size=(50, 24))).astype(np.float32)
    return [Y0, Y1, Y2]


def _three_cycles(mods, tmp):
    """cold -> appended rows -> replaced through ``mods``'s Watcher;
    (results, the online and delta events, the settings)."""
    cy, wa, rec = mods[:3]
    s = _settings(cy, tmp)
    data = os.path.join(str(tmp), "data")
    os.makedirs(data)
    w = wa.Watcher(data, s, runner=_runner(mods, s), log=lambda m: None)
    out = []
    with _Events(rec, os.path.join(str(tmp), "obs")) as ev:
        for Y in _data():
            np.save(os.path.join(data, cy.DATA_FILE), Y)
            out.append(w.run_once())
        assert w.run_once() is None            # unchanged: no cycle
        events = ev.events()
    return out, events, s, data


@pytest.fixture(scope="module")
def cycles(tmp_path_factory):
    return {name: _three_cycles(mods, tmp_path_factory.mktemp(name))
            for name, mods in (("jax", JAX), ("port", PORT))}


def _brief(e) -> tuple:
    keep = ("kind", "generation", "target_generation", "warm", "n", "p",
            "burnin", "mcmc", "num_shards", "delta")
    return (e["event"],) + tuple((k, e[k]) for k in keep if k in e)


def test_cycles_are_the_jax_packages(cycles):
    """The same event kinds, with the same kinds, generations, schedules
    and warm flags, and the same results, for cold -> appended rows ->
    replaced."""
    (j_res, j_ev, _, _), (t_res, t_ev, _, _) = cycles["jax"], cycles["port"]
    assert [_brief(e) for e in t_ev] == [_brief(e) for e in j_ev]
    assert [(r.generation, r.warm, r.manifest, r.delta is not None)
            for r in t_res] == [(r.generation, r.warm, r.manifest,
                                 r.delta is not None) for r in j_res]
    assert [r.generation for r in t_res] == [1, 2, 3]
    assert [r.warm for r in t_res] == [False, True, False]
    # generations 2 and 3 shipped as deltas against the serving one
    assert t_res[0].delta is None and t_res[1].delta["panels_total"] == 3


def test_a_port_root_opens_in_the_jax_package(cycles):
    """The port's promotion root: the JAX package's pointer reader and
    artifact open it, and its ``assemble()`` is bitwise the port's; the
    port watcher's state file gives the JAX watcher no plan on the same,
    unchanged data."""
    t_res, _, s, data = cycles["port"]
    st = jpro.read_pointer(s.root)
    assert st.generation == 3 == tpro.read_pointer(s.root).generation
    np.testing.assert_array_equal(
        jart.PosteriorArtifact.open(st.path).assemble(),
        tart.PosteriorArtifact.open(st.path).assemble())
    js = _settings(jcy, os.path.dirname(s.root))
    assert js.workdir == s.workdir
    w = jwa.Watcher(data, js, log=lambda m: None)
    assert w.load_state()["generation"] == 3
    assert w.scan() is None


def test_planning_is_the_jax_packages(tmp_path):
    """``classify``, ``plan_cycle`` and ``refit_config`` on the same
    manifests; the refit configs compared through the checkpoint's config
    JSON."""
    def m(n, p, fp):
        return {"n": n, "p": p, "fingerprint": fp}

    pairs = [(None, m(40, 24, "a")), (m(40, 24, "a"), m(40, 24, "a")),
             (m(40, 24, "a"), m(50, 24, "b")),
             (m(40, 24, "a"), m(40, 36, "b")),
             (m(40, 24, "a"), m(30, 24, "b")),
             (m(40, 24, "a"), m(40, 24, "b"))]
    for prev, cur in pairs:
        assert tcy.classify(prev, cur) == jcy.classify(prev, cur)
    out = {}
    for name, mods in (("jax", JAX), ("port", PORT)):
        cy, ck = mods[0], mods[5]
        s = _settings(cy, tmp_path / name, chunk_size=5, thin=2,
                      prior="horseshoe")
        rows = []
        for prev, cur in pairs:
            plan = cy.plan_cycle(s, prev, cur, "donor.ckpt.npz")
            if plan is None:
                rows.append(None)
                continue
            d = dataclasses.asdict(plan)
            d["checkpoint"] = os.path.relpath(d["checkpoint"], str(tmp_path
                                                                  / name))
            cfg = ck._config_to_json(cy.refit_config(s, plan))
            cfg["checkpoint_path"] = os.path.relpath(
                cfg["checkpoint_path"], str(tmp_path / name))
            cfg["stream_artifact"] = os.path.relpath(
                cfg["stream_artifact"], str(tmp_path / name))
            rows.append((d, json.dumps(cfg, sort_keys=True)))
        out[name] = rows
    assert out["port"] == out["jax"]
    assert sum(r is not None for r in out["port"]) == 5


def _fake_artifact(art, pre_mod, path, *, seed=0, p=24, g=2):
    """A CRC'd artifact with random panels (symmetric diagonal ones)."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((40, p)).astype(np.float32)
    pre = pre_mod.preprocess(Y, g)
    P = pre.shard_size
    q = rng.integers(-127, 128, size=(g * (g + 1) // 2, P, P)).astype(
        np.int8)
    pair = 0
    for a in range(g):
        for b in range(a, g):
            if a == b:
                q[pair] = np.triu(q[pair]) + np.triu(q[pair], 1).T
            pair += 1
    scale = rng.uniform(0.5, 1.5, len(q)).astype(np.float32)
    return art.write_artifact(path, mean_q8=q, mean_scale=scale,
                              pre=pre).path


def _negated(art, src, dst):
    """``src`` with every panel negated (it serves -S: drift 2)."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, art.META_FILE)) as f:
        meta = json.load(f)
    q = np.memmap(os.path.join(dst, art.MEAN_PANELS_FILE), dtype=np.int8,
                  mode="r+", shape=(3, meta["P"], meta["P"]))
    np.negative(q, out=q)
    q.flush()
    meta["panel_crc"]["mean"] = [int(art.panel_crc32(np.asarray(p)))
                                 for p in q]
    meta["fingerprint"] = art.artifact_fingerprint(meta)
    with open(os.path.join(dst, art.META_FILE), "w") as f:
        json.dump(meta, f)
    return dst


@pytest.mark.parametrize("refusal", ["refit", "torn", "drift"])
def test_refusals_are_typed_as_in_the_jax_package(tmp_path, refusal):
    """A failed refit, a torn candidate and the drift gate: the same typed
    CycleRefusedError at the same stage in both packages, and the pointer
    where it was."""
    outcomes = []
    for name, mods in (("jax", JAX), ("port", PORT)):
        cy, _, rec, art, pro, _, pre = mods
        tmp = tmp_path / name
        s = _settings(cy, tmp, max_drift=0.5)
        src = _fake_artifact(art, pre, str(tmp / "src"), seed=3)

        def runner(Y, cfg):
            if refusal == "refit":
                raise RuntimeError("the card fell over")
            shutil.copytree(src if refusal == "torn"
                            else _negated(art, src, str(tmp / "neg")),
                            cfg.stream_artifact)
            if refusal == "torn":
                with open(os.path.join(cfg.stream_artifact,
                                       art.MEAN_PANELS_FILE), "r+b") as f:
                    f.seek(7)
                    b = f.read(1)
                    f.seek(7)
                    f.write(bytes([b[0] ^ 0x5A]))

        prev = None
        if refusal == "drift":
            shutil.copytree(src, os.path.join(s.root, "v1"))
            pro.promote_artifact(s.root, "v1")
            prev = {"n": 40, "p": 24, "fingerprint": "a"}
        plan = cy.plan_cycle(s, prev, {"n": 50, "p": 24, "fingerprint": "b"},
                             None)
        with _Events(rec, str(tmp / "obs")) as ev:
            with pytest.raises(cy.CycleRefusedError) as e:
                cy.run_cycle(s, np.zeros((50, 24), np.float32), plan,
                             runner=runner)
            stage = ev.events(("online_refused",))[-1]["stage"]
        try:
            gen = pro.read_pointer(s.root).generation
        except pro.PointerError:
            gen = None
        outcomes.append((type(e.value).__name__, stage, gen,
                         str(e.value).split(":")[0]))
    assert outcomes[0] == outcomes[1]
    assert outcomes[1][2] == (1 if refusal == "drift" else None)


def test_watcher_loop_is_shutdown_safe(tmp_path):
    """The daemon loop consults ``stop`` on every turn and ``wake`` cuts
    the poll short."""
    s = _settings(tcy, tmp_path)
    w = twa.Watcher(str(tmp_path / "nodata"), s, interval=30.0,
                    log=lambda m: None)
    t = threading.Thread(target=w.run)
    t.start()
    w.stop.set()
    w.wake.set()
    t.join(timeout=10.0)
    assert not t.is_alive(), "the watcher ignored stop"
    assert w.cycles == 0


def test_supervised_refit_survives_a_kill(tmp_path, monkeypatch):
    """The default runner's supervised refit: launch 1 is SIGKILLed after
    its first save, the supervisor relaunches it, and the cycle promotes
    generation 1 from the resumed refit's streamed candidate."""
    monkeypatch.chdir(REPO)        # the children import the package
    tf.clear()
    monkeypatch.setenv("DCFM_FAULT_PLAN", json.dumps({"faults": [
        {"op": "kill", "at_iteration": 10, "when": "post_save",
         "at_launch": 1}]}))
    s = _settings(tcy, tmp_path, supervised=True, chunk_size=10)
    Y = _data()[0]
    plan = tcy.plan_cycle(s, None, {"n": 40, "p": 24, "fingerprint": "a"},
                          None)
    # one run directory for the cycle, the supervisor and its launches,
    # as watch_main exports it
    monkeypatch.setenv(trec.OBS_DIR_ENV_VAR, str(tmp_path / "obs"))
    with _Events(trec, str(tmp_path / "obs")) as ev:
        res = tcy.run_cycle(s, Y, plan,
                            runner=tcy.default_runner(s, "torch_cpu"))
        sup = [e["event"] for e in ev.events(("supervisor_",))]
    tf.clear()
    assert res.generation == 1 and not res.warm
    assert sup.count("supervisor_launch") == 2
    assert "supervisor_death" in sup and sup[-1] == "supervisor_done"
    art = tart.PosteriorArtifact.open(tpro.read_pointer(s.root).path)
    assert np.isfinite(art.assemble()).all()
