"""Every model knob the port's shard mesh (dcfm_tpu_torch/parallel/)
carries, one small case each on 4 gloo ranks of the CPU against the
one-process fit of the same config - f32, bf16 (K4's path), fused (K2's),
the MGP, horseshoe and DL priors, ``rank_adapt``, ``posterior_sd``,
missing data, ``store_draws``, ``combine_chunks`` and the R-hat early
stop - and lazy inputs (a memmap a rank reopens, a sparse matrix), each
rank reading its own shards.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu_torch as dt  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4       # tests/test_shard.py's mesh-parity band


def _cfg(g=8, K=3, C=1, mesh=0, model=None, run=None, backend=None, **kw):
    return dt.FitConfig(
        model=dt.ModelConfig(num_shards=g, factors_per_shard=K, rho=0.8,
                             **(model or {})),
        run=dt.RunConfig(**({"burnin": 10, "mcmc": 10, "thin": 1, "seed": 1,
                             "num_chains": C, "chunk_size": 5}
                            | (run or {}))),
        backend=dt.BackendConfig(backend="torch_cpu", mesh_devices=mesh,
                                 **(backend or {})), **kw)


def _close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


# every knob the mesh carries: (model, run, backend) over the f32 MGP base
_KNOBS = {
    "bf16": ({}, {}, {"compute_dtype": "bf16"}),
    "fused": ({"lambda_kernel": "pallas-fused"}, {}, {"sse_mode": "gram"}),
    "horseshoe": ({"prior": "horseshoe"}, {}, {}),
    "dl": ({"prior": "dl"}, {}, {}),
    "rank_adapt": ({"rank_adapt": True, "adapt": dt.AdaptConfig(
        a0=1.0, a1=-1e-3, eps=0.2, prop=0.6, min_active=1)}, {}, {}),
    "posterior_sd": ({"posterior_sd": True}, {}, {}),
    "store_draws": ({}, {"store_draws": True, "thin": 2}, {}),
    "combine_chunks": ({"combine_chunks": 4}, {}, {}),
    "early_stop": ({}, {"early_stop": "rhat", "num_chains": 2,
                        "chunk_size": 4, "rhat_threshold": 1e9,
                        "ess_target": 1e-9}, {}),
}


@pytest.mark.parametrize("knob", sorted(_KNOBS) + ["missing"])
def test_each_knob_runs_on_the_mesh(knob):
    """Each knob on 4 ranks against the one-process fit of the same
    config: the panels, the state, and what the knob adds to the result
    (the SD panels, the stored draws, the imputed data, the stop
    iteration)."""
    Y, _ = make_synthetic(60, 96, 3, seed=11)
    model, run, backend = _KNOBS.get(knob, ({}, {}, {}))
    if knob == "missing":
        Y = Y.copy()
        Y[np.random.default_rng(0).random(Y.shape) < 0.1] = np.nan
    kw = dict(model=model, run=run, backend=backend)
    one = dt.fit(Y, _cfg(**kw))
    mesh = dt.fit(Y, _cfg(mesh=4, **kw))
    # bf16: an ulp of difference in X can round an input to the next bf16
    # value (2^-8 relative); adaptation masks and rank counts agree exactly
    tol = (2e-2, 1e-3) if knob == "bf16" else (RTOL, ATOL)
    _close(one.sigma_blocks, mesh.sigma_blocks, *tol)
    _close(one.state.Lambda.numpy(), mesh.state.Lambda.numpy(), *tol)
    if knob == "posterior_sd":
        _close(one.sigma_sd_blocks, mesh.sigma_sd_blocks, *tol)
    if knob == "store_draws":
        for k in one.draws:
            _close(one.draws[k], mesh.draws[k], *tol)
    if knob == "missing":
        _close(one.Y_imputed, mesh.Y_imputed, *tol)
    if knob == "rank_adapt":
        # the coin fires every burn-in sweep (a0 = 1): the same columns
        # drop and return on both layouts
        assert torch.equal(one.state.active, mesh.state.active)
        assert mesh.stats.rank_mean == one.stats.rank_mean
    if knob == "early_stop":
        # the first boundary with 4 post-burn-in draws
        assert mesh.stopped_at_iter == one.stopped_at_iter == 16
    assert np.isfinite(mesh.Sigma).all()


@pytest.mark.parametrize("kind", ["memmap", "csr"])
def test_a_lazy_input_reaches_each_rank_as_its_own_shards(tmp_path, kind):
    """An out-of-core (np.memmap of a file, which a rank reopens by name)
    or sparse Y on 4 ranks: each rank reads its own block from the source,
    and the packed panels are the dense input's one-process fit's within
    the mesh band (the lazy fit keeps Sigma packed)."""
    from dcfm_tpu_torch.utils.preprocess import SparseMatrix
    Y, _ = make_synthetic(50, 96, 3, seed=12)
    if kind == "memmap":
        np.save(tmp_path / "Y.npy", Y)
        lazy = np.load(tmp_path / "Y.npy", mmap_mode="r")
    else:
        Y[np.random.default_rng(1).random(Y.shape) < 0.7] = 0.0
        rows, cols = np.nonzero(Y)
        indptr = np.searchsorted(rows, np.arange(Y.shape[0] + 1))
        lazy = SparseMatrix(indptr, cols, Y[rows, cols], Y.shape)
    one = dt.fit(Y, _cfg())
    mesh = dt.fit(lazy, _cfg(mesh=4))
    assert mesh.Sigma is None and mesh.preprocess.is_lazy
    _close(one.upper_panels, mesh.upper_panels)
