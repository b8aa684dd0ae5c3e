"""The port's promotion pointer and deltas against the JAX package's.

A delta the port writes is byte for byte the JAX package's from the same
base and candidate; each package materializes the other's delta into the
candidate's exact bytes; the typed refusals (torn, bit-flipped, wrong
base, rotted base panel) hold; the pointer files are the JAX promoter's
bytes; ``promote_delta`` is idempotent; and under a storm of client
threads a hot swap to a full generation and then to a delta generation
keeps every client's generation header monotone, with every response
bitwise its generation's ``assemble()``.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.parse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu.serve import delta as jdelta  # noqa: E402
from dcfm_tpu.serve import promote as jpromote  # noqa: E402
from dcfm_tpu.serve.artifact import PosteriorArtifact as JaxArtifact  # noqa: E402
from dcfm_tpu_torch.serve.artifact import (  # noqa: E402
    MAPS_FILE, MEAN_PANELS_FILE, META_FILE, SD_PANELS_FILE,
    ArtifactCorruptError, ArtifactError, PosteriorArtifact,
    artifact_fingerprint, panel_crc32)
from dcfm_tpu_torch.serve.delta import (  # noqa: E402
    DELTA_META_FILE, MEAN_DELTA_FILE, DeltaArtifact, DeltaBaseMismatchError,
    DeltaError, changed_pairs, materialize_delta, write_delta_artifact)
from dcfm_tpu_torch.serve.loadgen import run_load  # noqa: E402
from dcfm_tpu_torch.serve.promote import (  # noqa: E402
    POINTER_FILE, promote_artifact, promote_delta, read_pointer)
from dcfm_tpu_torch.serve.server import (  # noqa: E402
    GENERATION_HEADER, PosteriorServer)
from tests.test_torch_serve_server import P_ORIG, make_artifact  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _variant(src, dst, *, mean_pairs=(), sd_pairs=(), negate=False):
    """Copy ``src``; XOR-perturb the named pairs' panels (or negate every
    mean panel), re-recording the CRCs and the fingerprint."""
    shutil.copytree(src, dst)
    with open(os.path.join(dst, META_FILE), encoding="utf-8") as f:
        meta = json.load(f)
    n_pairs, P = meta["g"] * (meta["g"] + 1) // 2, meta["P"]
    for fname, kind, pairs in ((MEAN_PANELS_FILE, "mean", mean_pairs),
                               (SD_PANELS_FILE, "sd", sd_pairs)):
        if not pairs and not (negate and kind == "mean"):
            continue
        q = np.memmap(os.path.join(dst, fname), dtype=np.int8, mode="r+",
                      shape=(n_pairs, P, P))
        if negate and kind == "mean":
            np.negative(q, out=q)
        for pair in pairs:
            q[pair] ^= 0x55
        q.flush()
        meta["panel_crc"][kind] = [int(panel_crc32(np.asarray(p)))
                                   for p in q]
        del q
    meta["fingerprint"] = artifact_fingerprint(meta)
    with open(os.path.join(dst, META_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f)
    return dst


def _flip_byte(path, offset=7):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x5A]))


def _files(d):
    return {name: open(os.path.join(d, name), "rb").read()
            for name in sorted(os.listdir(d))}


def test_deltas_are_the_jax_packages_and_cross_materialize(tmp_path):
    v1 = make_artifact(str(tmp_path / "v1"), seed=1)
    cand = _variant(v1, str(tmp_path / "cand"), mean_pairs=(0, 2),
                    sd_pairs=(1,))
    base, jbase = PosteriorArtifact.open(v1), JaxArtifact.open(v1)
    d = write_delta_artifact(cand, base, str(tmp_path / "td"))
    jd = jdelta.write_delta_artifact(cand, jbase, str(tmp_path / "jd"))
    assert _files(d.path) == _files(jd.path)
    assert d.panels_changed == 3 and list(d.changed["mean"]) == [0, 2]
    assert {k: list(v) for k, v in changed_pairs(
        base, PosteriorArtifact.open(cand)).items()} == \
        {"mean": [0, 2], "sd": [1]}
    want = _files(cand)
    # each package materializes the OTHER's delta into the candidate
    a = materialize_delta(v1, jd.path, str(tmp_path / "from_jax"))
    b = jdelta.materialize_delta(v1, d.path, str(tmp_path / "from_port"))
    for out in (a.path, b.path):
        assert _files(out) == want
    # the empty delta of an unchanged candidate round-trips too
    e = write_delta_artifact(v1, base, str(tmp_path / "empty"))
    assert e.panels_changed == 0
    assert _files(materialize_delta(v1, e, str(tmp_path / "same")).path) \
        == _files(v1)


def test_typed_refusals(tmp_path):
    v1 = make_artifact(str(tmp_path / "v1"), seed=2)
    base = PosteriorArtifact.open(v1)
    cand = _variant(v1, str(tmp_path / "cand"), mean_pairs=(1,))
    # torn: delta.json is written last
    d = write_delta_artifact(cand, base, str(tmp_path / "torn"))
    os.unlink(os.path.join(d.path, DELTA_META_FILE))
    for mod, err in ((sys.modules[DeltaArtifact.__module__], DeltaError),
                     (jdelta, jdelta.DeltaError)):
        with pytest.raises(err, match="not a delta artifact"):
            mod.DeltaArtifact.open(d.path)
    # bit-flipped payload: refused before a byte lands
    d = write_delta_artifact(cand, base, str(tmp_path / "flip"))
    _flip_byte(os.path.join(d.path, MEAN_DELTA_FILE))
    with pytest.raises(ArtifactCorruptError, match="fails its CRC32"):
        materialize_delta(v1, d.path, str(tmp_path / "o1"))
    assert not os.path.exists(str(tmp_path / "o1"))
    # wrong base
    other = make_artifact(str(tmp_path / "other"), seed=99)
    d = write_delta_artifact(cand, base, str(tmp_path / "good"))
    with pytest.raises(DeltaBaseMismatchError,
                       match="pull the full candidate"):
        materialize_delta(other, d, str(tmp_path / "o2"))
    # a shape mismatch is a fall-back-to-full cue
    small = make_artifact(str(tmp_path / "small"), seed=3, p=12)
    with pytest.raises(DeltaError, match="ship the full artifact"):
        write_delta_artifact(small, base, str(tmp_path / "o3"))
    # a rotted UNCHANGED base panel fails the sweep; out stays unopenable
    _flip_byte(os.path.join(v1, MEAN_PANELS_FILE), offset=3)
    out = str(tmp_path / "o4")
    with pytest.raises(ArtifactCorruptError, match="stays unopenable"):
        materialize_delta(v1, d, out)
    with pytest.raises(ArtifactError):
        PosteriorArtifact.open(out)


def test_pointer_files_are_the_jax_promoters(tmp_path):
    """The same promotion history through each package's promoter leaves
    the same CURRENT and CURRENT.genN bytes; the verifying promoter
    refuses a corrupt candidate in both, and the CLI promotes."""
    roots = []
    for mod in (sys.modules[promote_artifact.__module__], jpromote):
        root = str(tmp_path / mod.__name__.split(".")[0])
        v1 = make_artifact(os.path.join(root, "v1"), seed=4)
        _variant(v1, os.path.join(root, "v2"), negate=True)
        assert mod.promote_artifact(root, "v1").generation == 1
        assert mod.promote_artifact(root, "v2").generation == 2
        shutil.copytree(os.path.join(root, "v2"), os.path.join(root, "v3"))
        _flip_byte(os.path.join(root, "v3", MEAN_PANELS_FILE))
        with pytest.raises(ArtifactError if mod is not jpromote
                           else jpromote.ArtifactError):
            mod.promote_artifact(root, "v3")
        st = mod.promote_artifact(root, "v3", verify=False)
        assert st.fingerprint != "unverified"     # opens: only a bit flipped
        roots.append(root)
    names = (POINTER_FILE, "CURRENT.gen1", "CURRENT.gen2", "CURRENT.gen3")
    for name in names:
        a = open(os.path.join(roots[0], name), "rb").read()
        b = open(os.path.join(roots[1], name), "rb").read()
        assert a == b, name
    cp = subprocess.run(
        [sys.executable, "-m", "dcfm_tpu_torch.cli", "promote", roots[0],
         os.path.join(roots[0], "v1")],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert cp.returncode == 0, cp.stderr
    assert json.loads(cp.stdout)["generation"] == 4
    assert read_pointer(roots[0]).target == "v1"


def test_promote_delta_is_idempotent(tmp_path):
    root = str(tmp_path)
    v1 = make_artifact(os.path.join(root, "v1"), seed=5)
    promote_artifact(root, "v1")
    cand = _variant(v1, str(tmp_path / "cand"), mean_pairs=(2,))
    write_delta_artifact(cand, PosteriorArtifact.open(v1),
                         os.path.join(root, "v2.delta"))
    assert promote_delta(root, "v2.delta", candidate="v2").generation == 2
    ino = os.stat(os.path.join(root, "v2", MEAN_PANELS_FILE)).st_ino
    assert promote_delta(root, "v2.delta", candidate="v2").generation == 3
    assert os.stat(os.path.join(root, "v2",
                                MEAN_PANELS_FILE)).st_ino == ino
    assert _files(os.path.join(root, "v2")) == _files(cand)


def test_hot_swaps_to_a_full_and_a_delta_generation_under_a_storm(
        tmp_path):
    """12 client threads; generation 2 (a full artifact) is promoted after
    100 answers and generation 3 (a delta against it) after 250.  Zero
    drops and untyped errors, monotone generation headers per client,
    every 200 bitwise its generation's assembly; the delta swap adopts
    the unchanged pairs."""
    root = str(tmp_path / "root")
    os.makedirs(root)
    v1 = make_artifact(os.path.join(root, "v1"), seed=6)
    v2 = _variant(v1, os.path.join(root, "v2"), negate=True)
    stage = _variant(v2, str(tmp_path / "v3"), mean_pairs=(0,),
                     sd_pairs=(2,))
    write_delta_artifact(stage, PosteriorArtifact.open(v2),
                         os.path.join(root, "v3.delta"))
    ref = {1: PosteriorArtifact.open(v1).assemble(),
           2: PosteriorArtifact.open(v2).assemble(),
           3: PosteriorArtifact.open(stage).assemble()}
    ref_sd = {g: PosteriorArtifact.open(p).assemble(kind="sd")
              for g, p in ((1, v1), (2, v2), (3, stage))}
    promote_artifact(root, "v1")
    srv = PosteriorServer(root, port=0, max_queue=1024, max_batch=32,
                          request_timeout=60.0, swap_poll=0.0, device="cpu")
    host, port = srv.start()
    seen, lock = {"ok": 0}, threading.Lock()

    def expect(kind, path, body, gen):
        with lock:
            seen["ok"] += 1
            n = seen["ok"]
        if n == 100:
            promote_artifact(root, "v2")
        elif n == 250:
            promote_delta(root, "v3.delta")
        q = urllib.parse.parse_qs(urllib.parse.urlparse(path).query)
        if kind == "healthz":
            return None if body["artifact_generation"] <= gen else "gen"
        if kind == "block":
            lo, hi = (int(v) for v in q["rows"][0].split(":"))
            want = ref[gen][lo:hi, lo:hi]
            got = np.asarray(body["values"], np.float32)
            return None if np.array_equal(got, want) else f"block {gen}"
        i, j = int(q["i"][0]), int(q["j"][0])
        if kind == "interval":
            ok = (np.float32(body["mean"]) == ref[gen][i, j]
                  and np.float32(body["sd"]) == ref_sd[gen][i, j])
            return None if ok else f"interval {gen} ({i},{j})"
        got = np.float32(body["value"])
        return (None if got == ref[gen][i, j]
                else f"generation {gen} ({i},{j}) {got!r}")

    try:
        res = run_load(f"http://{host}:{port}", threads=12,
                       requests_per_thread=40, seed=7, p=P_ORIG,
                       retries=2, timeout=60.0, expect=expect)
        m = srv.handle("/metrics", {})[1]
        eng = srv.engine
    finally:
        srv.close()
    assert res["dropped"] == 0 and res["untyped"] == []
    assert res["value_errors"] == []
    assert res["generation"]["violations"] == 0
    assert (res["generation"]["min"], res["generation"]["max"]) == (1, 3)
    assert m["swap"]["swaps"] == 2 and m["swap"]["refused"] == 0
    assert set(res["by_route"]) == {"entry", "block", "interval", "healthz"}
    # the delta generation serves its unchanged pairs from generation 2's
    # memmaps: mean pairs 1, 2 and sd pairs 0, 1
    assert eng.panels_adopted == 4
    assert eng.panel_source("mean", 0) == "new"
    assert eng.panel_source("sd", 2) == "new"
    assert eng.panel_source("mean", 1) == "adopted"
    assert srv.handle("/v1/entry", {"i": ["0"], "j": ["1"]})[2][
        GENERATION_HEADER] == "3"
