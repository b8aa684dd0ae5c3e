"""The port's ``.procK-of-N`` checkpoint sets against the JAX package's, on
the CPU (utils/checkpoint.py: ``save_checkpoint_multiprocess``,
``load_checkpoint_resharded``, ``load_checkpoint_multiprocess``,
``find_multiprocess_checkpoint``, ``discover_checkpoint``).

The sets cross both ways: a set written by a pod of 2 and of 4 gloo
processes is assembled by the JAX package's ``load_checkpoint_resharded``
into the leaves of the port's plain save of the same mesh fit, bit for
bit; a set the JAX package's ``save_checkpoint_multiprocess`` writes from
a carry sharded over the conftest's 8 CPU devices (8 blocks per split
leaf) is read by the port's loaders bit for bit.  Discovery picks what
the JAX package's picks on the same trees (incomplete, torn, old-format
and corrupt candidates, ties), and a flipped byte in one block is a
``CheckpointCorruptError`` in both packages.
"""

import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu.utils import checkpoint as jck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402
from tests.torch_pod_rank import run_pod_fit  # noqa: E402

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models.state import num_padded_pairs  # noqa: E402
from dcfm_tpu_torch.parallel.mesh import make_pod_layout  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

N, P_COLS, K, C = 40, 64, 3, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 3, seed=5)
    return Y


def _kw(g):
    return dict(model=dict(num_shards=g, factors_per_shard=K, rho=0.6),
                run=dict(burnin=10, mcmc=10, thin=2, seed=0, num_chains=C,
                         chunk_size=10),
                backend=dict(sse_mode="gram"))


def _cfg(pkg, g, backend=None, **fit_kw):
    kw = _kw(g)
    return pkg.FitConfig(model=pkg.ModelConfig(**kw["model"]),
                         run=pkg.RunConfig(**kw["run"]),
                         backend=pkg.BackendConfig(**kw["backend"],
                                                   **(backend or {})),
                         **fit_kw)


def _template(g):
    P = preprocess(_data(), g, seed=0).data.shape[2]
    return ck.carry_template(_cfg(dt, g).model, n=N, P=P, num_chains=C)


def _jax_template(g):
    m = _cfg(dcfm_tpu, g).model
    init_fn = dcfm_tpu.api._local_fns(m, 1, C)[0]
    P = preprocess(_data(), g, seed=0).data.shape[2]
    return jax.eval_shape(init_fn, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((g, N, P), np.float32))


@pytest.mark.parametrize("world", [2, 4])
def test_a_pods_set_is_the_jax_packages_set_of_the_mesh_fits_leaves(
        tmp_path, world):
    """A pod of ``world`` gloo processes writes one ``.procK-of-N`` file
    per process; the JAX package's loader assembles the set into the
    leaves of the port's plain file of the same fit on the shard mesh
    (``mesh_devices=world``, which gathers every carry to rank 0), bit for
    bit, and the port's own loader agrees.  Each file holds the process's
    blocks at their global offsets (the pair panels split, X whole)."""
    g = 4
    np.save(tmp_path / "Y.npy", _data())
    plain = str(tmp_path / "plain.npz")
    with deadline(90):
        mesh = dt.fit(_data(), _cfg(dt, g, {"mesh_devices": world},
                                    checkpoint_path=plain), device="cpu")
        base = str(tmp_path / "pod.npz")
        outs = run_pod_fit(dict(_kw(g), data=str(tmp_path / "Y.npy"),
                                out=str(tmp_path / "res"),
                                fit={"checkpoint_path": base}), world,
                           str(tmp_path), timeout=80)
    assert [rc for rc, _ in outs] == [0] * world, outs[0][1][-3000:]
    count, paths, it = ck.find_multiprocess_checkpoint(base)
    assert (count, it) == (world, 20)
    jcarry, jmeta = jck.load_checkpoint_resharded(paths, _jax_template(g))
    want, _ = ck.load_checkpoint(plain, _template(g))
    got = jax.tree.leaves(jcarry)
    assert len(got) == len(ck.FULL_LEAVES)
    for name, leaf in zip(ck.FULL_LEAVES, got, strict=True):
        np.testing.assert_array_equal(np.asarray(leaf), want[name])
    leaves, meta = ck.load_checkpoint_resharded(paths, _template(g))
    for name in ck.FULL_LEAVES:
        np.testing.assert_array_equal(leaves[name], want[name])
    assert (meta["process_count"], meta["pod_hosts"]) == (world, world)
    assert meta["topology"]["num_processes"] == world
    lm = meta["leaf_meta"]
    names = list(ck.FULL_LEAVES)
    assert lm[names.index("X")] == {"mode": "replicated"}
    pairs = lm[names.index("sigma_acc")]
    assert pairs == {"mode": "sharded", "offsets": [[0, 0, 0, 0]]}
    q = num_padded_pairs(g) // world
    m1 = ck.read_checkpoint_meta(paths[1])["leaf_meta"]
    assert m1[names.index("sigma_acc")]["offsets"] == [[0, q, 0, 0]]
    # every process of the pod returned the mesh fit's Sigma
    for r in range(world):
        with np.load(str(tmp_path / "res") + f".proc{r}.npz") as z:
            np.testing.assert_array_equal(z["Sigma"], mesh.Sigma)


def test_a_jax_written_set_is_read_by_the_port_bit_for_bit(tmp_path):
    """The JAX package's ``save_checkpoint_multiprocess`` of a carry sharded
    over 8 CPU devices (a ``.proc0-of-1`` set, each split leaf in 8 blocks
    keyed by their offsets) is read by the port's reshard assembly and by
    its rank-local fast path, every leaf the JAX carry's bits."""
    g = 8
    assert len(jax.devices()) >= 8
    src = str(tmp_path / "port.npz")
    dt.fit(_data(), _cfg(dt, g, checkpoint_path=src), device="cpu")
    host, meta = jck.load_checkpoint(src, _jax_template(g))
    leaves, treedef = jax.tree.flatten(host)
    mesh = Mesh(np.array(jax.devices()[:8]), ("shards",))
    placed = []
    for name, leaf in zip(ck.FULL_LEAVES, leaves, strict=True):
        spec = [None] * np.ndim(leaf)
        if name not in ("X", "iteration"):
            spec[1] = "shards"              # after the chain axis
        placed.append(jax.device_put(
            np.asarray(leaf), NamedSharding(mesh, PartitionSpec(*spec))))
    carry = jax.tree.unflatten(treedef, placed)
    base = str(tmp_path / "jax.npz")
    jck.save_checkpoint_multiprocess(base, carry, _cfg(dcfm_tpu, g),
                                     fingerprint=meta["fingerprint"])
    count, paths, it = ck.find_multiprocess_checkpoint(base)
    assert (count, it) == (1, 20)
    lm = ck.read_checkpoint_meta(paths[0])["leaf_meta"]
    assert len(lm[0]["offsets"]) == 8               # Lambda in 8 blocks
    want = dict(zip(ck.FULL_LEAVES, (np.asarray(x) for x in leaves)))
    got, _ = ck.load_checkpoint_resharded(paths, _template(g))
    fast, _ = ck.load_checkpoint_multiprocess(
        base, _template(g), layout=make_pod_layout(1, 0, g, C),
        source=("set", (count, paths, it)))
    for name in ck.FULL_LEAVES:
        np.testing.assert_array_equal(got[name], want[name])
        np.testing.assert_array_equal(fast[name], want[name])


def _fake(path, iteration, *, version=8, meta=None):
    """A minimal file: the meta keys discovery reads, no leaves."""
    ck._atomic_savez(path, dict({"version": version, "config": {},
                                 "treedef": "", "iteration": iteration,
                                 "fingerprint": "f"}, **(meta or {})), {})


def _set(base, n, iterations, **kw):
    for i, it in enumerate(iterations):
        _fake(ck.proc_path(base, i, n), it,
              meta={"process_index": i, "process_count": n}, **kw)


# each tree: (plain file's iteration, "corrupt" or None, {N: iterations of
# the set's members, one per present member}, the old-format set counts)
_TREES = {
    "nothing": (None, {}, ()),
    "incomplete set": (None, {2: [10]}, ()),
    "incomplete beside one": (None, {2: [10], 1: [4]}, ()),
    "most progress wins": (None, {1: [4], 2: [10, 10]}, ()),
    "tie to this pod's size": (None, {1: [10], 2: [10, 10]}, ()),
    "newer set over stale plain": (5, {2: [9, 9]}, ()),
    "newer plain over stale set": (12, {2: [9, 9]}, ()),
    "plain and set tie": (9, {2: [9, 9]}, ()),
    "torn set and plain": (15, {2: [20, 10]}, ()),
    "torn set alone": (None, {2: [20, 10]}, ()),
    "corrupt plain beside a set": ("corrupt", {2: [7, 7]}, ()),
    "old-format set beside plain": (5, {}, (2,)),
    "old-format set alone": (None, {}, (2,)),
}


def _tree(d, case):
    plain, sets, old = _TREES[case]
    base = os.path.join(d, "chain.ck")
    if plain == "corrupt":
        with open(base, "wb") as f:
            f.write(b"not an npz")
    elif plain is not None:
        _fake(base, plain)
    for n, its in sets.items():
        for i, it in enumerate(its):
            _fake(ck.proc_path(base, i, n), it,
                  meta={"process_index": i, "process_count": n})
    for n in old:
        _set(base, n, [3] * n, version=1)
    return base


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", type(e).__name__)


@pytest.mark.parametrize("case", sorted(_TREES))
def test_discovery_picks_what_the_jax_package_picks(tmp_path, case):
    """``find_multiprocess_checkpoint`` and ``discover_checkpoint`` (both
    tie preferences) give the JAX package's answer, paths included, or
    raise where it raises - one process, so a set of one process wins a
    progress tie against a larger set."""
    base = _tree(str(tmp_path), case)
    for port, jax_fn in (
            (lambda: ck.find_multiprocess_checkpoint(base),
             lambda: jck.find_multiprocess_checkpoint(base)),
            (lambda: ck.discover_checkpoint(base, prefer_plain=True),
             lambda: jck.discover_checkpoint(base, prefer_plain=True)),
            (lambda: ck.discover_checkpoint(base, prefer_plain=False),
             lambda: jck.discover_checkpoint(base, prefer_plain=False))):
        assert _outcome(port) == _outcome(jax_fn)


@pytest.mark.parametrize("light", [False, True])
def test_a_flipped_block_and_a_torn_set_are_refused_by_both_packages(
        tmp_path, light):
    """A light or full 2-rank set assembles to the plain file's leaves (a
    light set without accumulators, as a light file); a byte flipped in
    one block is a CheckpointCorruptError in both packages' assembly, and
    members one save apart are refused by both ("disagree on the
    iteration")."""
    from tests.torch_pod_rank import write_set
    g = 4
    src = str(tmp_path / "plain.npz")
    dt.fit(_data(), _cfg(dt, g, checkpoint_path=src, checkpoint_mode=(
        "light" if light else "full"), checkpoint_keep_last=2),
        device="cpu")
    base = str(tmp_path / "set.npz")
    paths = write_set(src, base, 2)
    want, _ = ck.load_checkpoint(src, _template(g))
    got, meta = ck.load_checkpoint_resharded(paths, _template(g))
    assert sorted(got) == sorted(want) and meta["state_only"] == light
    for name in want:
        np.testing.assert_array_equal(got[name], want[name])
    # members one save apart: proc1 from the previous generation
    write_set(ck.retained_path(src, 1), str(tmp_path / "old.npz"), 2)
    os.replace(ck.proc_path(str(tmp_path / "old.npz"), 1, 2), paths[1])
    for loader, tpl in ((ck.load_checkpoint_resharded, _template(g)),
                        (jck.load_checkpoint_resharded, _jax_template(g))):
        with pytest.raises(ValueError, match="disagree on the iteration"):
            loader(paths, tpl)
    paths = write_set(src, base, 2)
    with np.load(paths[1]) as z:
        entry = next(k for k in z.files if k.endswith("_s0"))
        raw = z[entry].tobytes()
    data = bytearray(open(paths[1], "rb").read())
    data[bytes(data).index(raw[:64]) + 5] ^= 1
    open(paths[1], "wb").write(bytes(data))
    with pytest.raises(ck.CheckpointCorruptError):
        ck.load_checkpoint_resharded(paths, _template(g))
    with pytest.raises(Exception, match="CRC|Bad CRC"):
        jck.load_checkpoint_resharded(paths, _jax_template(g))
