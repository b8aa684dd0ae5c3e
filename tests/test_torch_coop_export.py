"""The pod's cooperative artifact export (serve/artifact.py:
``write_artifact_cooperative``, ``export_fit_result_cooperative``) against
the JAX package's, on the CPU.

A 2-process gloo pod fitted with ``stream_artifact`` writes its artifact
cooperatively (a pod keeps the replicated post-hoc fetch, so nothing
streams): each process writes its slice of the panel files, process 0 the
CRCs of the stitched files, the maps and ``meta.json``.  The JAX
package's ``export_fit_result_cooperative`` of the pod's own panels, run
in 2 threads meeting at a ``threading.Barrier``, writes the same panel
binaries and ``meta.json`` byte for byte and equal ``maps.npz`` arrays.
The port's writer over 3 threads (slices of unequal length) is the JAX
package's one-process ``write_artifact`` byte for byte.
"""

import functools
import os
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu  # noqa: E402
from dcfm_tpu.serve import artifact as jart  # noqa: E402
from dcfm_tpu.utils.preprocess import preprocess as jpreprocess  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402
from tests.torch_mesh_deadline import deadline  # noqa: E402
from tests.torch_pod_rank import run_pod_fit, same_artifact_bytes  # noqa: E402

from dcfm_tpu_torch.serve import artifact as tart  # noqa: E402

N, P_COLS, G, K = 40, 64, 4, 3
KW = dict(model=dict(num_shards=G, factors_per_shard=K, rho=0.6,
                     posterior_sd=True),
          run=dict(burnin=10, mcmc=10, thin=2, seed=0, num_chains=2,
                   chunk_size=10),
          backend=dict(sse_mode="gram", fetch_dtype="quant8"))


@functools.lru_cache(maxsize=None)
def _data():
    Y, _ = make_synthetic(N, P_COLS, 3, seed=11)
    return Y


def _jax_cfg():
    return dcfm_tpu.FitConfig(
        model=dcfm_tpu.ModelConfig(**KW["model"]),
        run=dcfm_tpu.RunConfig(**KW["run"]),
        backend=dcfm_tpu.BackendConfig(**KW["backend"]))


def _jax_pre():
    cfg = _jax_cfg()
    return jpreprocess(_data(), G, permute=cfg.permute,
                       standardize=cfg.standardize,
                       pad_to_shards=cfg.pad_to_shards, seed=cfg.run.seed)


def _threads(n, fn):
    """``fn(i, barrier)`` in ``n`` threads meeting at one barrier (the
    pod's barrier, as the JAX package's tests stand it in)."""
    bar = threading.Barrier(n, timeout=60)
    errors = []

    def run(i):
        try:
            fn(i, lambda tag: bar.wait())
        except BaseException as e:   # surfaced below
            errors.append(e)
            bar.abort()

    ts = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]


def test_the_pods_artifact_is_the_jax_cooperative_writers(tmp_path):
    """The pod's ``stream_artifact``, written cooperatively by its 2
    processes, against the JAX package's cooperative export of the same
    panels in 2 threads: mean and SD panel files and ``meta.json`` byte for
    byte (the CRCs of the stitched files, the provenance, the
    fingerprint), ``maps.npz`` arrays equal; the artifact opens in both
    packages and both processes fetched the same panels."""
    np.save(tmp_path / "Y.npy", _data())
    art = str(tmp_path / "art")
    with deadline(90):
        codes = run_pod_fit(dict(KW, data=str(tmp_path / "Y.npy"),
                                 out=str(tmp_path / "res"),
                                 fit={"stream_artifact": art}), 2,
                            str(tmp_path), timeout=75)
    assert [c for c, _ in codes] == [0, 0], codes[0][1][-3000:]
    res = [dict(np.load(str(tmp_path / "res") + f".proc{r}.npz"))
           for r in range(2)]
    for k in ("q8_panels", "q8_scales", "sd_q8_panels", "sd_q8_scales"):
        np.testing.assert_array_equal(res[0][k], res[1][k])
    fake = types.SimpleNamespace(
        _q8_panels=res[0]["q8_panels"], _q8_scales=res[0]["q8_scales"],
        _sd_q8_panels=res[0]["sd_q8_panels"],
        _sd_q8_scales=res[0]["sd_q8_scales"], config=_jax_cfg(),
        preprocess=_jax_pre())
    ref = str(tmp_path / "jax")
    _threads(2, lambda i, barrier: jart.export_fit_result_cooperative(
        fake, ref, process_index=i, process_count=2, barrier=barrier))
    same_artifact_bytes(art, ref)
    assert jart.PosteriorArtifact.open(art).fingerprint == \
        tart.PosteriorArtifact.open(art).fingerprint
    assert tart.PosteriorArtifact.open(art).meta["provenance"][
        "source"] == "fit"


@pytest.mark.parametrize("procs", [1, 3])
def test_the_cooperative_writer_is_the_one_process_writer(tmp_path, procs):
    """The port's ``write_artifact_cooperative`` in ``procs`` threads
    (``cooperative_pair_slice``: slices of 3, 3 and 4 of the 10 panels
    over 3) writes the JAX package's one-process ``write_artifact`` of the
    same panels byte for byte, and the slices are the JAX package's."""
    rng = np.random.default_rng(0)
    pre = _jax_pre()
    n_pairs, P = G * (G + 1) // 2, pre.p_used // G
    q8 = rng.integers(-127, 128, (n_pairs, P, P), dtype=np.int8)
    sd = rng.integers(0, 128, (n_pairs, P, P), dtype=np.int8)
    scale = rng.random(n_pairs).astype(np.float32)
    kw = dict(mean_q8=q8, mean_scale=scale, pre=pre, sd_q8=sd,
              sd_scale=scale * 0.5, provenance={"source": "fit"})
    ref = str(tmp_path / "ref")
    jart.write_artifact(ref, **kw)
    got = str(tmp_path / "got")
    _threads(procs, lambda i, barrier: tart.write_artifact_cooperative(
        got, process_index=i, process_count=procs, barrier=barrier, **kw))
    same_artifact_bytes(got, ref)
    assert [tart.cooperative_pair_slice(n_pairs, i, procs)
            for i in range(procs)] == [
        jart.cooperative_pair_slice(n_pairs, i, procs) for i in range(procs)]
    assert os.path.exists(os.path.join(got, "meta.json"))
