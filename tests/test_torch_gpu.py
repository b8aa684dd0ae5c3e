"""Card-only tests of the PyTorch port: the hand-written CUDA kernels
against their plain PyTorch versions on the card, the bf16 product, small
fits whose main paths launch the kernels (f32 through K1, bf16 through K4,
pallas-fused through K2; K5 in each) as CUDA graphs, the graphed chain
against the eager chain bit for bit, the fetch (the pinned, sliced drain
against a plain copy, the fetch prep against the CPU's, fits at every
fetch_dtype), the posterior SD (its accumulate inside the graphs, its
fetch prep against the CPU's), the streamed artifact and the export from
a checkpoint, an elastic resume, a failed capture raising, the scenario
paths (the horseshoe and DL priors, rank adaptation) graphed bitwise the
eager chain, and the last knobs: missing values (the imputation inside
the graphs on the f32, bf16 and fused paths) and the draw ring (its slot
a device tensor) graphed bitwise the eager chain; the chunked combine
graphed bitwise the eager chain, the lazy (sparse, memmap) upload bitwise
the dense one, and a memmap fit's panels bitwise its dense twin's; a
warm-started fit graphed bitwise the eager one, and a recorded and
profiled fit bitwise the plain one, its trace naming K1 and K5 and its
sweep's stages timed on the device, and a profiled DL fit's GIG sampler
timed inside its prior update and its draws and rounds counted; the query
engine on the card bitwise the one on the CPU (entries, blocks, rows,
intervals, an evicting budget) and one request served by ``serve
--device cuda``; the shard mesh's rank program as a 1-rank NCCL world,
bitwise the one-device fit on the f32, bf16 and fused paths, and with the
streamed quant8 fetch, a warm start and a grow of the chain count.

They need an NVIDIA GPU with nvcc (the kernels are built on first use) and
skip without one.  They import no JAX, so on the card they run without the
repo's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu_torch import AdaptConfig, BackendConfig, FitConfig  # noqa: E402
from dcfm_tpu_torch import ModelConfig, RunConfig  # noqa: E402
from dcfm_tpu_torch import api, fit  # noqa: E402
from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models.conditionals import mm_bf16  # noqa: E402
from dcfm_tpu_torch.models.priors import make_prior  # noqa: E402
from dcfm_tpu_torch.noise import TorchNoise  # noqa: E402
from dcfm_tpu_torch.ops import batched_solve as bs  # noqa: E402
from dcfm_tpu_torch.ops import cuda_lib  # noqa: E402
from dcfm_tpu_torch.ops.chol_sample import chol_sample, chol_sample_plain  # noqa: E402
from dcfm_tpu_torch.ops.lam_update import lam_update, lam_update_plain  # noqa: E402
from dcfm_tpu_torch.ops.sse_gamma import sse_ps, sse_ps_plain  # noqa: E402
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.serve.artifact import PosteriorArtifact  # noqa: E402
from dcfm_tpu_torch.serve.artifact import export_from_checkpoint  # noqa: E402
from dcfm_tpu_torch.utils.checkpoint import state_leaf_names  # noqa: E402
from dcfm_tpu_torch.utils.preprocess import preprocess  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """The card, or a skip: decided here, at run time, so every xdist
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _spd(rng, B, K):
    A = rng.standard_normal((B, K, K)).astype(np.float32)
    return A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(K, dtype=np.float32)


# K1's and K4's shapes: the fit's batch, then every K in 1..16 (lanes of the
# W-lane group idle unless K is a power of two) on batches ragged against
# the group and the block (1, 3, 33 and 10,049 systems)
_SOLVE_SHAPES = [(10048, 8), (10049, 1), (513, 4), (10049, 16), (1, 5)] + [
    (B, K) for K in range(1, 17) for B in (1, 3, 33, 10049)
    if (B, K) not in ((10049, 1), (10049, 16))]


@pytest.mark.parametrize("B,K", _SOLVE_SHAPES)
def test_chol_sample_kernel_matches_plain(cuda, B, K):
    rng = np.random.default_rng(K)
    Q = torch.as_tensor(_spd(rng, B, K), device=cuda)
    b = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    z = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    before = cuda_lib.launch_counts()["chol_sample"]
    out = chol_sample(Q, b, z)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["chol_sample"] == before + 1
    # reciprocal-multiply vs divide in the backward solves, FMA contraction:
    # float32 rounding, the JAX package's own 2e-4 kernel-vs-unrolled band
    torch.testing.assert_close(out, chol_sample_plain(Q, b, z),
                               rtol=2e-4, atol=2e-4)


# K5's shapes: K = 8 at the fit's batch; K = 1, 4, 5 and 16 through the
# fixed-K kernel (float4 loads at 4, 8, 16) and K = 24 through the
# run-time-K kernel, on batches ragged against the 64-thread block
@pytest.mark.parametrize("B,K", [(10048, 8), (10049, 1), (513, 4), (700, 5),
                                 (10049, 8), (10049, 16), (129, 24),
                                 (10049, 24), (1, 8)])
def test_sse_ps_kernel_matches_plain_and_clamps(cuda, B, K):
    rng = np.random.default_rng(5)
    Lam, M, EYt = (rng.standard_normal((B, K)).astype(np.float32)
                   for _ in range(3))
    quad = np.sum(Lam.astype(np.float64) * M, axis=1)
    dot2 = np.sum(Lam.astype(np.float64) * EYt, axis=1)
    sse_true = rng.uniform(0, 100, B)
    sse_true[:16] = -1e-3                  # overshoot: must clamp to 0
    yty = (sse_true + 2 * dot2 - quad).astype(np.float32)
    bad = B // 2 if B > 32 else None       # a poisoned feature
    if bad is not None:
        yty[bad] = np.nan
    g = rng.gamma(50.5, 1.0, B).astype(np.float32)
    t = [torch.as_tensor(a, device=cuda) for a in (Lam, M, EYt, yty, g)]
    before = cuda_lib.launch_counts()["sse_ps"]
    ps, sse = sse_ps(*t, bs=0.3)
    ps_p, sse_p = sse_ps_plain(*t, 0.3)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["sse_ps"] == before + 1
    assert torch.all(sse[:16] == 0)
    good = torch.ones(B, dtype=torch.bool, device=cuda)
    if bad is not None:                    # NaN is kept, and stays put
        assert torch.isnan(sse[bad]) and torch.isnan(ps[bad])
        good[bad] = False
    assert torch.isfinite(sse[good]).all() and torch.isfinite(ps[good]).all()
    # K float32 products summed in another order: a few ulp of the terms
    torch.testing.assert_close(sse[good], sse_p[good], rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ps[good], ps_p[good], rtol=1e-4, atol=1e-6)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    Q = torch.eye(3, device=cuda).expand(4, 3, 3)
    b = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        chol_sample(Q, b, b)
    with pytest.raises(TypeError, match="float32"):
        chol_sample(Q.contiguous().double(), b.double(), b.double())  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test


# the three solve kernels against their plain versions; float32 rounding
# only (FMA contraction, and for K1/K2 the reciprocal the plain version
# also multiplies by), inside the JAX package's 2e-4 kernel band
_KERNEL_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,K", _SOLVE_SHAPES)
def test_batched_solve_kernels_match_plain(cuda, B, K):
    rng = np.random.default_rng(100 + K)
    Q = torch.as_tensor(_spd(rng, B, K), device=cuda)
    b = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    z = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    before = cuda_lib.launch_counts()
    x4 = bs.chol_solve_sample_batched(Q, b, z)
    x3 = bs.cho_solve_batched(Q, b)
    torch.cuda.synchronize()
    after = cuda_lib.launch_counts()
    assert after["chol_solve_sample"] == before["chol_solve_sample"] + 1
    assert after["cho_solve"] == before["cho_solve"] + 1
    torch.testing.assert_close(x4, bs.chol_solve_sample_plain(Q, b, z),
                               **_KERNEL_TOL)
    torch.testing.assert_close(x3, bs.cho_solve_plain(Q, b), **_KERNEL_TOL)


@pytest.mark.parametrize("K", [3, 8, 16])
@pytest.mark.parametrize("poison", ["nan", "not-spd"])
def test_a_poisoned_system_stays_in_its_own_row(cuda, poison, K):
    """One system of a warp is poisoned (a NaN in Q's lower triangle, or a
    negative definite Q): in K1 and K4 only its own row of the output is
    non-finite, as in the plain versions; every other row, its neighbours
    in the same warp included, matches the plain version."""
    rng = np.random.default_rng(300 + K)
    B = 64
    W = 1 << (K - 1).bit_length()          # lanes per system
    bad = 32 // W + 1                      # the second system of warp 1
    Qn = _spd(rng, B, K)
    if poison == "nan":
        Qn[bad, K - 1, 0] = Qn[bad, 0, K - 1] = np.nan
    else:
        Qn[bad] = -np.eye(K, dtype=np.float32)
    Q = torch.as_tensor(Qn, device=cuda)
    b = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    z = torch.as_tensor(rng.standard_normal((B, K), np.float32), device=cuda)
    good = torch.arange(B, device=cuda) != bad
    for kernel, plain in ((chol_sample, chol_sample_plain),
                          (bs.chol_solve_sample_batched,
                           bs.chol_solve_sample_plain)):
        out, ref = kernel(Q, b, z), plain(Q, b, z)
        torch.cuda.synchronize()
        assert not torch.isfinite(ref[bad]).all()
        assert not torch.isfinite(out[bad]).all()
        assert torch.isfinite(out[good]).all()
        torch.testing.assert_close(out[good], ref[good], **_KERNEL_TOL)


def _lam_operands(rng, G, P, K):
    A = rng.standard_normal((G, K, K)).astype(np.float32)
    E = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(K, dtype=np.float32)
    return [E, (rng.gamma(2.0, 1.0, (G, P, K)) + 0.1).astype(np.float32),
            rng.gamma(3.0, 0.5, (G, P)).astype(np.float32),
            rng.standard_normal((G, P, K)).astype(np.float32),
            rng.standard_normal((G, P, K)).astype(np.float32)]


# K2's shapes: every K in 1..16 (lanes of the W-lane group idle unless K is
# a power of two) on one row, on the fit's (64, 157) and on shards whose
# rows are ragged against the group and the block
@pytest.mark.parametrize("K", range(1, 17))
@pytest.mark.parametrize("G,P", [(1, 1), (3, 33), (64, 157), (2, 65)])
def test_lam_update_kernel_matches_plain(cuda, G, P, K):
    t = [torch.as_tensor(a, device=cuda)
         for a in _lam_operands(np.random.default_rng(200 + K), G, P, K)]
    before = cuda_lib.launch_counts()["lam_update"]
    out = lam_update(*t)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["lam_update"] == before + 1
    torch.testing.assert_close(out, lam_update_plain(*t), **_KERNEL_TOL)


@pytest.mark.parametrize("K", [3, 8, 16])
@pytest.mark.parametrize("poison", ["nan", "not-spd"])
def test_a_poisoned_loading_row_stays_in_its_own_row(cuda, poison, K):
    """One loading row of a warp is poisoned (a NaN residual precision, or
    a negative prior precision that makes its Q indefinite): in K2 only its
    own row of the output is non-finite, as in the plain version; every
    other row, its neighbours in the same warp included, matches it."""
    G, P = 2, 40
    ops = _lam_operands(np.random.default_rng(400 + K), G, P, K)
    W = 1 << (K - 1).bit_length()          # lanes per row
    bad = 32 // W + 1                      # the second row of warp 1
    if poison == "nan":
        ops[2][1, bad] = np.nan
    else:
        ops[1][1, bad, 0] = -1e4
    t = [torch.as_tensor(a, device=cuda) for a in ops]
    out, ref = lam_update(*t), lam_update_plain(*t)
    torch.cuda.synchronize()
    good = torch.ones((G, P), dtype=torch.bool, device=cuda)
    good[1, bad] = False
    assert not torch.isfinite(ref[1, bad]).all()
    assert not torch.isfinite(out[1, bad]).all()
    assert torch.isfinite(out[good]).all()
    torch.testing.assert_close(out[good], ref[good], **_KERNEL_TOL)


def test_lam_rows_refuses_more_rows_than_the_grid_holds(cuda):
    """One launch takes at most (2^31 - 1) * 8 rows with P < 2^31: the C
    entry refuses more before it launches (no pointer is read)."""
    t = [torch.zeros(8, device=cuda) for _ in range(6)]
    ptrs = [a.data_ptr() for a in t]
    for G, P in ((1 << 20, 1 << 20), (1, 1 << 31), (0, 5)):
        with pytest.raises(RuntimeError, match="invalid argument"):
            cuda_lib.call("dcfm_lam_rows", t[0].device, *ptrs, G, P, 8)


def test_new_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    Q = torch.eye(3, device=cuda).expand(4, 3, 3)
    b = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        bs.chol_solve_sample_batched(Q, b, b)
    with pytest.raises(TypeError, match="float32"):
        bs.cho_solve_batched(Q.contiguous().double(), b.double())  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    E = torch.eye(3, device=cuda).expand(2, 3, 3)
    plam = torch.ones((2, 5, 3), device=cuda)
    ps = torch.ones((2, 5), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        lam_update(E, plam, ps, plam, plam)
    with pytest.raises(TypeError, match="float32"):
        lam_update(E.contiguous(), plam, ps.double(), plam, plam)  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test


# the combine kernel's shapes: K through its fixed-K kernels and its
# run-time-K kernel (20), at the north star's P = 157 (one column a
# thread) and config 5's 196 (float4 columns); then P wider than a block's
# row of threads and than a slab's shared memory (2 and 3 slabs a panel)
_COMBINE_SHAPES = [(P, K) for P in (157, 196) for K in (1, 4, 8, 16, 20)] \
    + [(1028, 16), (1201, 20)]


@pytest.mark.parametrize("sd", [False, True])
@pytest.mark.parametrize("estimator", ["scaled", "plain"])
@pytest.mark.parametrize("P,K", _COMBINE_SHAPES)
def test_combine_kernel_matches_plain(cuda, P, K, estimator, sd):
    """g = 4 shards (10 upper pairs padded to 12 with aliases of (0, 0)),
    the range [3, 12) - not starting at 0, the padded pairs in it - added
    into accumulators that already hold draws: one launch, nothing outside
    the range touched, and every entry within float32 rounding of the
    plain version's.  Both round M = Lam_r H and the K-term dots in their
    own order, so an entry's panel value may differ by 4 (K + 1) eps
    sum_k |Lam_r||H| |Lam_c| (the plain rule: |Lam_r| |Lam_c|) plus 2 eps
    of the panel, and the sums by 2 eps of the accumulator more; a square
    by (2 |b| + db) db + 2 eps b^2 + 2 eps |sq|."""
    from dcfm_tpu_torch.models.conditionals import cross_moments
    from dcfm_tpu_torch.models.state import packed_pair_indices
    from dcfm_tpu_torch.ops.combine import (
        combine_panels, combine_panels_plain)
    rng = np.random.default_rng(1000 + 10 * K + P)
    g, c0, rho = 4, 3, 0.9
    rows, cols = (torch.as_tensor(x, dtype=torch.long, device=cuda)
                  for x in packed_pair_indices(g))
    Q = rows.shape[0]

    def dev(shape, kind="normal"):
        x = (rng.standard_normal(shape) if kind == "normal"
             else rng.gamma(2.0, 1.0, shape))
        return torch.as_tensor(x.astype(np.float32), device=cuda)

    Lam, ps = dev((g, P, K)), dev((g, P), "gamma")
    H = (cross_moments(dev((g, 30, K))) if estimator == "scaled" else None)
    acc0, sq0 = dev((Q, P, P)), dev((Q, P, P), "gamma")
    out = {}
    for name, fn in (("kernel", functools.partial(combine_panels, rho=rho,
                                                  H_grid=H)),
                     ("plain", functools.partial(combine_panels_plain,
                                                 rho=rho, H_grid=H))):
        acc, sq = acc0.clone(), sq0.clone()
        before = cuda_lib.launch_counts()["combine_panels"]
        fn(acc[c0:], sq[c0:] if sd else None, Lam, ps, rows[c0:], cols[c0:])
        torch.cuda.synchronize()
        launched = cuda_lib.launch_counts()["combine_panels"] - before
        assert launched == (1 if name == "kernel" else 0)
        assert torch.equal(acc[:c0], acc0[:c0])
        assert torch.equal(sq[:c0] if sd else sq, sq0[:c0] if sd else sq0)
        out[name] = acc, sq
    eps = float(np.finfo(np.float32).eps)
    r, c = rows[c0:].cpu().numpy(), cols[c0:].cpu().numpy()
    L64, p64 = Lam.cpu().numpy().astype(np.float64), ps.cpu().numpy()
    if H is not None:
        H64 = H.cpu().numpy().astype(np.float64)[r, c]
        M, Mabs = L64[r] @ H64, np.abs(L64[r]) @ np.abs(H64)
        scale = np.ones(Q - c0)
    else:
        M, Mabs = L64[r], np.abs(L64[r])
        scale = np.where(r == c, 1.0, np.float32(rho))
    Lc = np.swapaxes(L64[c], 1, 2)
    b = (M @ Lc) * scale[:, None, None]
    idx = np.arange(P)
    b[:, idx, idx] += (r == c)[:, None] / p64[r]
    db = (4 * (K + 1) * eps * (Mabs @ np.abs(Lc)) * scale[:, None, None]
          + 2 * eps * np.abs(b))
    (ka, ks), (pa, pq) = ((x.cpu().numpy() for x in out[k])
                          for k in ("kernel", "plain"))
    gap = np.abs(ka[c0:] - pa[c0:].astype(np.float64))
    tol = db + 2 * eps * np.abs(pa[c0:])
    assert (gap <= tol).all(), float((gap / tol).max())
    if sd:
        gap = np.abs(ks[c0:] - pq[c0:].astype(np.float64))
        tol = ((2 * np.abs(b) + db) * db + 2 * eps * b * b
               + 2 * eps * np.abs(pq[c0:]))
        assert (gap <= tol).all(), float((gap / tol).max())


def test_mm_bf16_on_the_card_matches_the_cpu_rule(cuda):
    """cuBLAS's bf16 GEMM with float32 output against the CPU rule (bf16
    inputs multiplied exactly in float32): only the summation order
    differs; a bf16-rounded output would miss by 2e-3 of the scale."""
    rng = np.random.default_rng(9)
    for sa, sb in (((64, 500, 157), (64, 157, 8)), ((500, 8), (64, 8, 157)),
                   ((157, 8), (8, 157))):
        a = torch.as_tensor(rng.standard_normal(sa).astype(np.float32))
        b = torch.as_tensor(rng.standard_normal(sb).astype(np.float32))
        ref = mm_bf16(a, b)
        out = mm_bf16(a.to(cuda), b.to(cuda)).cpu()
        assert out.dtype == torch.float32
        scale = float(ref.abs().max())
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5 * scale)


def _small_data():
    rng = np.random.default_rng(1)
    L = rng.normal(size=(96, 4)) / 2
    Y = (rng.normal(size=(150, 4)) @ L.T
         + 0.2 * rng.normal(size=(150, 96))).astype(np.float32)
    return Y, L @ L.T + 0.04 * np.eye(96)


def _small_fit(cuda, **knobs):
    """A fit on the card (graphed: its trips of 8 sweeps replay captured
    graphs); returns its kernel launches."""
    Y, St = _small_data()
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel=knobs.get("lambda_kernel", "pallas")),
        run=RunConfig(burnin=150, mcmc=150, thin=2, num_chains=2,
                      sweep_unroll=8),
        backend=BackendConfig(sse_mode="gram",
                              compute_dtype=knobs.get("compute_dtype",
                                                      "f32")))
    res = fit(Y, cfg, device=cuda)
    assert np.isfinite(res.Sigma).all() and res.stats.nonfinite_count == 0
    assert np.linalg.norm(res.Sigma - St) / np.linalg.norm(St) < 0.25
    # 300 iterations a chain in trips of 8 (burn-in 150 ends inside a
    # trip): 38 trips a chain, 4 save patterns, each eager once, captured
    # at its second meeting and replayed from then on
    assert res.graphs == dict(res.graphs, unroll=8, captured=4,
                              replays=2 * 38 - 4, eager_trips=4)
    return res.kernel_launches


# each path with another link dtype (the fused one with the posterior SD
# beside the mean): the mesh's fetch gathers each rank's link panels
_MESH_PATHS = {"f32": {"fetch_dtype": "float32"},
               "bf16": {"compute_dtype": "bf16", "lambda_kernel": "auto",
                        "fetch_dtype": "bfloat16"},
               "fused": {"lambda_kernel": "pallas-fused",
                         "fetch_dtype": "quant8", "posterior_sd": True}}


@pytest.mark.parametrize("path", sorted(_MESH_PATHS))
def test_a_one_rank_nccl_mesh_is_bitwise_the_one_device_fit(cuda, path):
    """The shard mesh's rank program as a world of one NCCL rank
    (``api._fit(..., one_rank_mesh=True)``): its all-reduces and
    all-gathers run inside the CUDA graphs and are counted per replay (3
    all-reduces a sweep, 3 all-gathers a saved draw), the path's kernels
    once per sweep, and Sigma (the SD too), the fetched panels and the
    state are the one-device fit's bits; a mesh wider than the cards is
    the JAX package's ValueError."""
    knobs = _MESH_PATHS[path]
    Y, _ = _small_data()
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel=knobs.get("lambda_kernel", "pallas"),
                          posterior_sd=knobs.get("posterior_sd", False)),
        run=RunConfig(burnin=40, mcmc=40, thin=2, num_chains=2,
                      sweep_unroll=8),
        backend=BackendConfig(sse_mode="gram",
                              compute_dtype=knobs.get("compute_dtype",
                                                      "f32"),
                              fetch_dtype=knobs["fetch_dtype"]))
    one = fit(Y, cfg, device=cuda)
    cuda_lib.reset_collective_counts()
    mesh = api._fit(Y, cfg, cuda, one_rank_mesh=True)
    np.testing.assert_array_equal(mesh.Sigma, one.Sigma)
    np.testing.assert_array_equal(mesh.upper_panels, one.upper_panels)
    if knobs.get("posterior_sd"):
        np.testing.assert_array_equal(mesh.Sigma_sd, one.Sigma_sd)
        np.testing.assert_array_equal(mesh._sd_q8_panels,
                                      one._sd_q8_panels)
    for a, b in zip(sampler.state_leaves(mesh.state),
                    sampler.state_leaves(one.state), strict=True):
        assert torch.equal(a, b)
    assert mesh.kernel_launches == one.kernel_launches
    assert mesh.graphs["replays"] > 0
    assert cuda_lib.collective_counts() == {"all_reduce": 3 * 160,
                                            "all_gather": 3 * 40}
    with pytest.raises(ValueError, match="no silent fallback"):
        fit(Y, dataclasses.replace(cfg, backend=BackendConfig(
            mesh_devices=torch.cuda.device_count() + 1)), device=cuda)


def test_the_mesh_runs_on_the_card_the_caller_named(cuda, monkeypatch):
    """A one-rank mesh fit asked for on the last card runs its rank there
    (rank r on the r-th card from the caller's), and a mesh one rank wider
    than the cards from there is the JAX package's ValueError."""
    from dcfm_tpu_torch.parallel import shard
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    started = []

    def spy(*a, **kw):
        started.append(shard.start_mesh(*a, **kw))
        return started[-1]

    monkeypatch.setattr(api, "start_mesh", spy)
    Y, _ = _small_data()
    cfg = FitConfig(model=ModelConfig(num_shards=4, factors_per_shard=4,
                                      rho=0.9),
                    run=RunConfig(burnin=8, mcmc=8, thin=2),
                    backend=BackendConfig(sse_mode="gram"))
    res = api._fit(Y, cfg, last, one_rank_mesh=True)
    assert [m.device for m in started] == [last]
    assert np.isfinite(res.Sigma).all()
    with pytest.raises(ValueError, match="but only 1 devices visible"):
        fit(Y, dataclasses.replace(cfg, backend=BackendConfig(
            mesh_devices=2)), device=last)


def _mesh_knob_cfg(**run):
    return FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9),
        run=RunConfig(**({"burnin": 20, "mcmc": 20, "thin": 2,
                          "num_chains": 2, "chunk_size": 10} | run)),
        backend=BackendConfig(sse_mode="gram", fetch_dtype="quant8"),
        permute=False)


@pytest.mark.parametrize("knob", ["stream", "warm", "grow"])
def test_a_one_rank_nccl_mesh_streams_warm_starts_and_grows(cuda, tmp_path,
                                                            knob):
    """The knobs the mesh once refused, as a 1-rank NCCL world against one
    device: the streamed quant8 fetch into a serve artifact (the post-hoc
    fetch's panels, scales and Sigma), a warm start with new shards (2 ->
    4, decision warm) and a 1-chain file at the burn-in boundary grown to
    2 chains (the same elastic bookkeeping); Sigma and state bitwise."""
    import shutil

    from dcfm_tpu_torch.config import WarmStart
    Y, _ = _small_data()
    cfg = _mesh_knob_cfg()
    if knob == "stream":
        cfg = dataclasses.replace(cfg, stream_artifact=str(tmp_path / "a"),
                                  backend=dataclasses.replace(
                                      cfg.backend, fetch_stream="on"))
        one = fit(Y, dataclasses.replace(cfg, stream_artifact=None,
                                         backend=dataclasses.replace(
                                             cfg.backend,
                                             fetch_stream="off")),
                  device=cuda)
    elif knob == "warm":
        donor = str(tmp_path / "donor.npz")
        fit(Y[:, :Y.shape[1] // 2], dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_shards=2),
            checkpoint_path=donor), device=cuda)
        cfg = dataclasses.replace(cfg, warm_start=WarmStart(donor),
                                  obs=str(tmp_path / "obs"))
        one = fit(Y, dataclasses.replace(cfg, obs="off"), device=cuda)
    else:
        src = str(tmp_path / "burnin.npz")
        api._fit(Y, dataclasses.replace(
            _mesh_knob_cfg(mcmc=0, num_chains=1), checkpoint_path=src),
            cuda, one_rank_mesh=True)
        for name in ("one", "mesh"):
            shutil.copy(src, str(tmp_path / f"{name}.npz"))
        cfg = dataclasses.replace(cfg, resume=True,
                                  checkpoint_path=str(tmp_path / "mesh.npz"))
        one = fit(Y, dataclasses.replace(
            cfg, checkpoint_path=str(tmp_path / "one.npz")), device=cuda)
    cuda_lib.reset_collective_counts()
    with mock.patch.object(api, "_fit", functools.partial(
            api._fit, one_rank_mesh=True)):
        mesh = fit(Y, cfg, device=cuda)         # the recorder's session
    np.testing.assert_array_equal(mesh.Sigma, one.Sigma)
    np.testing.assert_array_equal(mesh._q8_panels, one._q8_panels)
    np.testing.assert_array_equal(mesh._q8_scales, one._q8_scales)
    for a, b in zip(sampler.state_leaves(mesh.state),
                    sampler.state_leaves(one.state), strict=True):
        assert torch.equal(a, b)
    assert mesh.kernel_launches == one.kernel_launches
    assert mesh.graphs["replays"] > 0
    if knob == "stream":
        assert mesh.stream_stats["snapshots"] >= 1
        np.testing.assert_array_equal(
            PosteriorArtifact.open(cfg.stream_artifact).assemble(),
            one.Sigma)
    elif knob == "warm":
        from dcfm_tpu_torch.obs import run_events
        assert [e["decision"] for e in run_events(cfg.obs)
                if e["event"] == "warm_start"] == ["warm"]
    else:
        assert mesh.elastic_resume == one.elastic_resume
        assert mesh.elastic_resume["birthed"] == 1
    sweeps = 2 * (40 if knob != "grow" else 20)
    assert cuda_lib.collective_counts() == {"all_reduce": 3 * sweeps,
                                            "all_gather": 3 * 20}


def _combines(run: RunConfig, *, start: int = 0, chains=None,
              ranges: int = 1) -> int:
    """The combine kernel's launches in a float32 fit of ``run`` that ran
    iterations (start, burnin + mcmc] of each chain: one a combine range
    (ModelConfig.combine_chunks) of each saved draw of each chain."""
    end = run.burnin + run.mcmc
    saved = sum(sampler.save_pattern(start, end - start, run.burnin,
                                     run.thin))
    return (run.num_chains if chains is None else chains) * saved * ranges


def test_small_fit_runs_both_kernels(cuda):
    """600 sweeps: K1 and K5 once each per sweep, the combine kernel once
    per saved draw (75 a chain)."""
    assert _small_fit(cuda) == {"chol_sample": 600, "chol_solve_sample": 0,
                                "cho_solve": 0, "lam_update": 0,
                                "sse_ps": 600, "combine_panels": 150}


@pytest.mark.parametrize("knobs,kernel", [
    ({"compute_dtype": "bf16", "lambda_kernel": "auto"}, "chol_solve_sample"),
    ({"lambda_kernel": "pallas-fused"}, "lam_update")])
def test_small_bf16_and_fused_fits_run_their_kernels(cuda, knobs, kernel):
    """600 sweeps: the path's Lambda kernel and K5 once each per sweep; the
    combine kernel once per saved draw, except under bf16, whose combine
    keeps its GEMMs."""
    launches = _small_fit(cuda, **knobs)
    expected = dict.fromkeys(launches, 0)
    expected.update({kernel: 600, "sse_ps": 600,
                     "combine_panels": 0 if "compute_dtype" in knobs
                     else 150})
    assert launches == expected


# the graphed chain against the eager one: chunk 13, thin 3, trips of 5
# (nothing divides anything), burn-in 11 ending inside a trip, two chains so
# that chain 1 replays every pattern chain 0 met, the crossing trip's too
_GRAPH_PATHS = [(sse, dt, lk) for sse in ("resid", "gram")
                for dt, lk in (("f32", "pallas"), ("bf16", "auto"),
                               ("f32", "pallas-fused"))]


def _run_chains(cuda, cfg, graphs, *, num_stored_draws=0, missing=0.0):
    """Both chains through a runner; per chain the state leaves, the
    accumulator, health and the trace, copied to the host (then the
    second moment, the draw ring of ``num_stored_draws`` slots and the
    imputation sum where present), and the launches and the runner's
    counts.  ``missing``: a fraction of Y set to NaN at random."""
    Y, _ = _small_data()
    if missing:
        Y = Y.copy()
        Y[np.random.default_rng(2).random(Y.shape) < missing] = np.nan
    Yd = torch.as_tensor(preprocess(Y, cfg.num_shards, seed=0).data,
                         device=cuda)
    runner = sampler.ChainRunner(TorchNoise(0, cuda), Yd, cfg,
                                 make_prior(cfg), burnin=11, thin=3,
                                 unroll=5, graphs=graphs,
                                 num_stored_draws=num_stored_draws)
    out = []
    cuda_lib.reset_launch_counts()
    for c in range(2):
        carry, traces = runner.init_chain(c), []
        while carry.iteration < 38:
            carry, _, tr = runner.run_chunk(c, carry,
                                            min(13, 38 - carry.iteration))
            traces.append(tr.cpu())
        out.append([t.cpu() for t in sampler.state_leaves(carry.state)]
                   + [carry.sigma_acc.cpu(), carry.health.cpu(),
                      torch.cat(traces)]
                   + ([] if carry.sigma_sq_acc is None
                      else [carry.sigma_sq_acc.cpu()])
                   + [t.cpu() for t in sampler.draw_leaves(carry.draws)]
                   + ([] if carry.y_imp_acc is None
                      else [carry.y_imp_acc.cpu()]))
    counts = (runner.captured, runner.replays, runner.eager_trips)
    return out, cuda_lib.launch_counts(), counts


@pytest.mark.parametrize("sse_mode,compute_dtype,lambda_kernel",
                         _GRAPH_PATHS)
def test_graph_chain_equals_eager_chain_bitwise(cuda, sse_mode,
                                                compute_dtype,
                                                lambda_kernel):
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode=sse_mode, compute_dtype=compute_dtype,
                      lambda_kernel=lambda_kernel)
    eager, n_eager, c_eager = _run_chains(cuda, cfg, graphs=False)
    graph, n_graph, c_graph = _run_chains(cuda, cfg, graphs=True)
    names = ["Lambda", "Z", "X", "ps", "delta", "psijh", "sigma_acc",
             "health", "trace"]
    for c in range(2):
        for name, a, b in zip(names, eager[c], graph[c], strict=True):
            assert torch.equal(a, b), (c, name, float((a - b).abs().max()))
    # chunks of 13 / 13 / 12 in trips [5, 5, 3], [5, 5, 3], [5, 5, 2]: 18
    # trips; of chain 0's 7 save patterns (the all-burn-in 5 twice, the
    # crossing 3, and 5, 5, 3, 5, 5, 2 after it, one 5 met twice) 2 are
    # captured in chain 0 and the other 5 in chain 1, which only replays
    assert c_eager == (0, 0, 18)
    assert c_graph == (7, 11, 7)                 # captured, replays, eager
    assert n_graph == n_eager
    # the Lambda kernel every sweep, K5 every Gram sweep, the combine
    # kernel every saved draw (9 a chain) but under bf16's GEMM combine
    assert sum(n_eager.values()) == 2 * 38 * (1 + (sse_mode == "gram")) \
        + (0 if compute_dtype == "bf16" else 2 * 9)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("n", [2080, 7, 1])
def test_pinned_sliced_drain_equals_a_plain_copy(cuda, dtype, n):
    """The drain's slices land in pinned host memory on the side stream,
    each behind its event; what it returns is a plain .cpu() of the same
    tensor, bit for bit - right after the kernel that wrote the tensor."""
    x = torch.randn(n, 33, 33, device=cuda) * 50  # dcfm-torch: ignore[DCFM101] - test data: only the host copy is compared with its source
    x = x.to(torch.int8) if dtype == torch.int8 else x.to(dtype)
    y = x * 1 if dtype == torch.int8 else x * 2      # just queued
    d = fetch.Drain(y)
    assert d.host.is_pinned() and len(d.ranges) == min(n, 8)
    want = y.cpu()
    want = (want.float() if dtype in (torch.bfloat16, torch.float16)
            else want).numpy()
    np.testing.assert_array_equal(d.wait(), want)


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "quant8"])
@pytest.mark.parametrize("C", [1, 2, 3])
def test_fetch_prep_on_the_card_is_the_cpus(cuda, mode, C):
    """The chain mean, trim, division and link cast on the card give the
    CPU's bits (tests/test_torch_fetch.py holds the CPU to the JAX fetch):
    one correctly rounded multiply, round half to even, a true division."""
    g, P = 9, 157
    rng = np.random.default_rng(C)
    accs = (rng.standard_normal((C, 45, P, P))
            * rng.uniform(0.1, 100.0, (C, 1, 1, 1))).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        pooled = torch.as_tensor(accs[0], device=dev).clone()
        for c in range(1, C):
            pooled += torch.as_tensor(accs[c], device=dev)
        got = fetch.fetch_prep(pooled, C, g, np.float32(1 / 101), mode)
        out[str(dev)] = [t.cpu() for t in (got if mode == "quant8"
                                           else (got,))]
    for a, b in zip(out["cpu"], out[str(cuda)], strict=True):
        assert torch.equal(a, b)


def test_small_fits_at_each_fetch_dtype(cuda, tmp_path):
    """The same chain on the card fetched four ways: every Sigma within
    its link's rounding of the float32 fetch's (quant8: scale/254 of each
    panel times the two column scales), the quant8 export opens to the
    quant8 Sigma bit for bit, and materialize_sigma='never' keeps the
    panels packed."""
    Y, _ = _small_data()

    def run(mode, materialize="auto"):
        cfg = FitConfig(
            model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                              lambda_kernel="pallas"),
            run=RunConfig(burnin=50, mcmc=50, thin=2, num_chains=2),
            backend=BackendConfig(sse_mode="gram", fetch_dtype=mode),
            materialize_sigma=materialize)
        return fit(Y, cfg, device=cuda)

    ref = run("float32")
    for mode, rtol in (("bfloat16", 2 ** -8), ("float16", 2 ** -11)):
        np.testing.assert_allclose(run(mode).Sigma, ref.Sigma, rtol=rtol,
                                   atol=1e-6)
    q8 = run("quant8")
    s = ref.preprocess.col_scale.reshape(-1)
    bound = q8._q8_scales.max() / 254 * s.max() ** 2
    assert np.abs(q8.Sigma - ref.Sigma).max() <= bound * (1 + 1e-5)
    art = q8.export_artifact(str(tmp_path / "art"))
    np.testing.assert_array_equal(PosteriorArtifact.open(art.path).assemble(),
                                  q8.Sigma)
    lazy = run("quant8", "never")
    assert lazy.Sigma is None
    np.testing.assert_array_equal(lazy._q8_panels, q8._q8_panels)


def _ckpt_cfg(lambda_kernel="pallas", compute_dtype="f32", **kw):
    return FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel=lambda_kernel),
        run=RunConfig(burnin=40, mcmc=40, thin=2, num_chains=2,
                      chunk_size=16, sweep_unroll=4),
        backend=BackendConfig(sse_mode="gram", compute_dtype=compute_dtype),
        **kw)


class _Killed(BaseException):
    pass


@pytest.mark.parametrize("knobs", [
    {}, {"compute_dtype": "bf16", "lambda_kernel": "auto"},
    {"lambda_kernel": "pallas-fused"}])
def test_a_killed_graphed_fit_resumes_bitwise_on_the_card(cuda, tmp_path,
                                                          monkeypatch,
                                                          knobs):
    """The write-behind writer (snapshots on a side stream while the next
    chunk replays) until the second save lands, then a kill: the resumed
    graphed fit is the uninterrupted one's bits, and checkpointing on
    changes no bit either.  A save falls due at every boundary (16, 32,
    ..., 80), but one the writer is still busy at is deferred, so the
    second save lands at a boundary the card's timing picks: the kill
    follows it wherever it lands before the last boundary."""
    from dcfm_tpu_torch.runtime import pipeline
    from dcfm_tpu_torch.utils import checkpoint as ck
    Y, _ = _small_data()
    ref = fit(Y, _ckpt_cfg(**knobs), device=cuda)
    path = str(tmp_path / "ck.npz")
    cfg = _ckpt_cfg(**knobs, checkpoint_path=path, checkpoint_every_chunks=1)
    on = fit(Y, cfg, device=cuda)
    np.testing.assert_array_equal(on.Sigma, ref.Sigma)
    save = ck.save_checkpoint
    landed = []

    def save_then_kill(p, leaves, c, **kw):
        # the writer thread stores the kill; the chunk loop raises it at a
        # later boundary, before any further save
        save(p, leaves, c, **kw)
        landed.append(int(np.asarray(leaves["iteration"]).reshape(-1)[0]))
        if len(landed) == 2:
            raise _Killed()

    monkeypatch.setattr(pipeline, "save_checkpoint", save_then_kill)
    with pytest.raises(_Killed):
        fit(Y, cfg, device=cuda)
    monkeypatch.undo()
    at = landed[-1]
    assert landed[0] == 16 and 16 < at < 80, landed
    assert ck.read_checkpoint_meta(path)["iteration"] == at
    res = fit(Y, dataclasses.replace(cfg, resume=True), device=cuda)
    np.testing.assert_array_equal(res.Sigma, ref.Sigma)
    assert res.traces.shape == (2, 80 - at, 4) and res.graphs["replays"] > 0


def test_a_resumed_graphed_chain_is_the_resumed_eager_chain(cuda, tmp_path):
    """From one checkpoint, a graphed and an eager runner run the rest of
    the chains: every leaf, accumulator and trace bitwise."""
    from dcfm_tpu_torch.runtime import pipeline
    from dcfm_tpu_torch.utils import checkpoint as ck
    Y, _ = _small_data()
    path = str(tmp_path / "ck.npz")
    cfg = dataclasses.replace(_ckpt_cfg(checkpoint_path=path),
                              run=RunConfig(burnin=40, mcmc=0, num_chains=2,
                                            chunk_size=16))
    res = fit(Y, cfg, device=cuda)
    m = dataclasses.replace(cfg.model, sse_mode="gram")
    tpl = ck.carry_template(m, n=150, P=res.preprocess.data.shape[2],
                            num_chains=2)
    leaves, _ = ck.load_checkpoint(path, tpl)
    Yd = torch.as_tensor(res.preprocess.data, device=cuda)
    out = {}
    for graphs in (False, True):
        runner = sampler.ChainRunner(TorchNoise(0, cuda), Yd, m,
                                     make_prior(m), burnin=40, thin=2,
                                     unroll=4, graphs=graphs)
        carries = pipeline.carries_from_leaves(leaves, 2, cuda,
                                               tpl["sigma_acc"][0][-3:])
        traces = []
        for _ in range(3):
            for c, carry in enumerate(carries):
                traces.append(runner.run_chunk(c, carry, 14)[2].cpu())
        out[graphs] = ([t.cpu() for c in carries
                        for t in sampler.carry_tensors(c)] + traces)
        assert runner.replays > 0 or not graphs
    for a, b in zip(out[False], out[True], strict=True):
        assert torch.equal(a, b)


def test_a_snapshot_taken_while_replays_run_is_a_synchronous_save(cuda):
    """A snapshot's copy runs on a side stream while the next chunk
    replays on the runner's stream: it holds the boundary's bits, and the
    replays waited for it before writing the carries back."""
    from dcfm_tpu_torch.utils import checkpoint as ck
    Y, _ = _small_data()
    m = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                    lambda_kernel="pallas", sse_mode="gram")
    Yd = torch.as_tensor(preprocess(Y, 4, seed=0).data, device=cuda)
    runner = sampler.ChainRunner(TorchNoise(0, cuda), Yd, m, make_prior(m),
                                 burnin=4, thin=2, unroll=4)
    carries = [runner.new_chain(c) for c in range(2)]
    for _ in range(3):                # warm: every pattern captured
        for c, carry in enumerate(carries):
            runner.run_chunk(c, carry, 8)
    want = {k: v.copy() for k, v in ck.Snapshot(
        carries, state_only=False).wait().items()}
    snap = ck.Snapshot(carries, state_only=False)
    replays = runner.replays
    for c, carry in enumerate(carries):
        runner.run_chunk(c, carry, 8)
    assert runner.replays > replays
    got = snap.wait()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    torch.cuda.synchronize()
    assert all(not c.readers for c in carries)


def test_a_streamed_quant8_fit_on_the_card_is_the_post_hoc_one(cuda):
    Y, _ = _small_data()
    out = {}
    for stream in ("off", "auto"):
        cfg = dataclasses.replace(_ckpt_cfg(), backend=BackendConfig(
            sse_mode="gram", fetch_dtype="quant8", fetch_stream=stream))
        out[stream] = fit(Y, cfg, device=cuda)
    assert out["off"].stream_stats is None
    assert out["auto"].stream_stats["snapshots"] > 0
    for k in ("Sigma", "_q8_panels", "_q8_scales"):
        np.testing.assert_array_equal(getattr(out["auto"], k),
                                      getattr(out["off"], k))


@pytest.mark.parametrize("compute_dtype,lambda_kernel", [
    ("f32", "pallas"), ("bf16", "auto"), ("f32", "pallas-fused")])
def test_sd_graph_chain_equals_eager_chain_bitwise(cuda, compute_dtype,
                                                   lambda_kernel):
    """posterior_sd: the square and its add are graph nodes too; every
    leaf, sigma_sq_acc included, bitwise the eager chain's."""
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", compute_dtype=compute_dtype,
                      lambda_kernel=lambda_kernel, posterior_sd=True)
    eager, n_eager, _ = _run_chains(cuda, cfg, graphs=False)
    graph, n_graph, c_graph = _run_chains(cuda, cfg, graphs=True)
    names = ["Lambda", "Z", "X", "ps", "delta", "psijh", "sigma_acc",
             "health", "trace", "sigma_sq_acc"]
    for c in range(2):
        for name, a, b in zip(names, eager[c], graph[c], strict=True):
            assert torch.equal(a, b), (c, name, float((a - b).abs().max()))
        assert graph[c][-1].abs().sum() > 0
    assert c_graph == (7, 11, 7) and n_graph == n_eager


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "float16",
                                  "quant8"])
@pytest.mark.parametrize("C", [1, 2])
def test_sd_prep_on_the_card_is_the_cpus(cuda, mode, C):
    """fetch_sd_prep on the card against the CPU's on the same sums: the
    mean (fetch_prep) is the CPU's bits, the float32 SD within one float32
    ulp (measured on an H100: 5.96e-8 at values up to 0.5, a last-bit
    difference), so a link-cast SD within one unit of the link dtype's
    last place (an entry whose float32 value straddles a rounding
    boundary) and a quant8 SD within one int8 step, its scales within one
    float32 ulp."""
    g, P = 9, 157
    rng = np.random.default_rng(10 + C)
    centre = rng.standard_normal((45, P, P)).astype(np.float32)
    accs, sqs = [], []
    for _ in range(C):
        d = centre + 0.3 * rng.standard_normal((5, 45, P, P)).astype(
            np.float32)
        accs.append(d.sum(axis=0))
        sqs.append((d * d).sum(axis=0))
    out = {}
    for dev in ("cpu", cuda):
        pooled = torch.as_tensor(accs[0], device=dev).clone()
        sq = torch.as_tensor(sqs[0], device=dev).clone()
        for c in range(1, C):
            pooled += torch.as_tensor(accs[c], device=dev)
            sq += torch.as_tensor(sqs[c], device=dev)
        inv = np.float32(1 / 5)
        mean = fetch.fetch_prep(pooled, C, g, inv, mode)
        got = fetch.fetch_sd_prep(sq, pooled[:45], C, inv,
                                  np.float32(5 * C / (5 * C - 1)), mode)
        out[str(dev)] = [t.cpu() for t in (
            (*mean, *got) if mode == "quant8" else (mean, got))]
    cpu, card = out["cpu"], out[str(cuda)]
    for a, b in zip(cpu[:len(cpu) // 2], card[:len(cpu) // 2], strict=True):
        assert torch.equal(a, b)                        # the mean
    eps = torch.finfo(torch.float32).eps
    if mode == "quant8":
        (q, s), (qc, sc) = cpu[2:], card[2:]
        assert (q.int() - qc.int()).abs().max() <= 1
        assert ((s - sc).abs() <= eps * s.abs()).all()
        return
    a, b = cpu[1].float(), card[1].float()
    ulp = eps if mode == "float32" else {
        "bfloat16": 2.0 ** -7, "float16": 2.0 ** -10}[mode]
    assert ((a - b).abs() <= ulp * torch.maximum(a.abs(), b.abs())).all()


def test_a_small_sd_fit_streams_and_exports_on_the_card(cuda, tmp_path):
    """posterior_sd on the card: K1 and K5 once per sweep; a finite,
    non-negative SD; the streamed artifact (SD panels beside the mean's)
    is the post-hoc export byte for byte; the export of the fit's final
    checkpoint is its own export (mean bytes, SD within one step)."""
    Y, _ = _small_data()
    base = dataclasses.replace(_ckpt_cfg(), model=dataclasses.replace(
        _ckpt_cfg().model, posterior_sd=True))

    def run(**kw):
        cfg = dataclasses.replace(base, **kw)
        cuda_lib.reset_launch_counts()
        res = fit(Y, cfg, device=cuda)
        torch.cuda.synchronize()
        return res, cuda_lib.launch_counts()

    q8 = BackendConfig(sse_mode="gram", fetch_dtype="quant8")
    path = str(tmp_path / "ck.npz")
    f32, launches = run(checkpoint_path=path)
    assert launches == dict(dict.fromkeys(launches, 0), chol_sample=160,
                            sse_ps=160, combine_panels=_combines(base.run))
    assert np.isfinite(f32.Sigma_sd).all() and (f32.Sigma_sd >= 0).all()
    streamed, _ = run(backend=q8, stream_artifact=str(tmp_path / "s"))
    post, _ = run(backend=dataclasses.replace(q8, fetch_stream="off"))
    post.export_artifact(str(tmp_path / "p"))
    assert streamed.stream_stats["snapshots"] > 0
    for name in ("mean_q8.bin", "sd_q8.bin"):
        assert ((tmp_path / "s" / name).read_bytes()
                == (tmp_path / "p" / name).read_bytes())
    bound = post._sd_q8_scales[:, None, None] / 254
    assert (np.abs(post.sd_upper_panels - f32.sd_upper_panels)
            <= bound * (1 + 1e-5)).all()
    art = export_from_checkpoint(path, Y, str(tmp_path / "e"))
    own = f32.export_artifact(str(tmp_path / "o"))
    assert art.mean_panels.tobytes() == own.mean_panels.tobytes()
    step = np.maximum(art.sd_scale, own.sd_scale)[:, None, None] / 127
    da = art.sd_panels * (art.sd_scale / 127)[:, None, None]
    db = own.sd_panels * (own.sd_scale / 127)[:, None, None]
    assert (np.abs(da - db) <= step * (1 + 1e-5)).all()


@pytest.mark.parametrize("to", [1, 3])
def test_an_elastic_resume_on_the_card(cuda, tmp_path, to):
    """A 2-chain file at iteration 48 resumed at 1 and at 3 chains on the
    card: the adoption's bookkeeping, the path's kernels once per executed
    sweep, and a Sigma inside the quality rule."""
    Y, St = _small_data()
    path = str(tmp_path / "e.npz")
    short = dataclasses.replace(_ckpt_cfg(checkpoint_path=path),
                                run=RunConfig(burnin=40, mcmc=8, thin=2,
                                              num_chains=2, chunk_size=16,
                                              sweep_unroll=4))
    fit(Y, short, device=cuda)
    cfg = _ckpt_cfg(checkpoint_path=path, resume=True)
    cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                           num_chains=to))
    cuda_lib.reset_launch_counts()
    res = fit(Y, cfg, device=cuda)
    torch.cuda.synchronize()
    el = res.elastic_resume
    assert (el["from_chains"], el["to_chains"]) == (2, to)
    assert el["fold_draws"] == (4 if to == 1 else 0)
    assert el["chain_acc_starts"] == ((0,) if to == 1 else (0, 0, 48))
    sweeps = to * (80 - 48)
    assert res.kernel_launches == dict(
        dict.fromkeys(res.kernel_launches, 0), chol_sample=sweeps,
        sse_ps=sweeps, combine_panels=_combines(cfg.run, start=48))
    assert np.isfinite(res.Sigma).all()
    assert np.linalg.norm(res.Sigma - St) / np.linalg.norm(St) < 0.25


def test_a_failed_capture_raises_and_is_not_hidden(cuda, monkeypatch):
    """A sweep op that synchronizes (an .item() in the trace) runs eagerly
    but cannot be captured: fit raises and does not fall back to the eager
    chain.  Kept last in the file: the failed capture is left behind."""
    trace_now = sampler._trace_now

    def syncing_trace(*args):
        out = trace_now(*args)
        out[0].item()
        return out

    monkeypatch.setattr(sampler, "_trace_now", syncing_trace)
    with pytest.raises(RuntimeError, match="CUDA graph failed"):
        _small_fit(cuda)


# the scenario paths: the horseshoe and DL priors, rank adaptation (firing
# from the first sweep: a0 > 0), and the fused Lambda kernel with a mask
_SCEN = {"dl": {"prior": "dl"},
         "hs_adapt": {"prior": "horseshoe", "rank_adapt": True},
         "mgp_adapt": {"rank_adapt": True},
         "dl_adapt": {"prior": "dl", "rank_adapt": True},
         "hs_adapt_fused": {"prior": "horseshoe", "rank_adapt": True,
                            "lambda_kernel": "pallas-fused"}}
_FIRE = AdaptConfig(a0=1.0, a1=-1e-3, eps=0.2, prop=0.6)


@pytest.mark.parametrize("scen", sorted(_SCEN))
def test_scenario_graph_chain_equals_eager_chain_bitwise(cuda, scen):
    """Every leaf - the prior's, the column mask, the accumulator, health
    and the trace - of the graphed chain bitwise the eager chain's, across
    trips in which the mask changes (the candidate tables and the GIG
    rounds drawn outside the graph, the iteration a device tensor)."""
    knobs = {"lambda_kernel": "pallas"} | _SCEN[scen]
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", adapt=_FIRE, **knobs)
    eager, n_eager, _ = _run_chains(cuda, cfg, graphs=False)
    graph, n_graph, c_graph = _run_chains(cuda, cfg, graphs=True)
    names = list(state_leaf_names(cfg)) + ["sigma_acc", "health", "trace"]
    for c in range(2):
        for name, a, b in zip(names, eager[c], graph[c], strict=True):
            assert torch.equal(a, b), (c, name, float((a - b).abs().max()))
    if cfg.rank_adapt:
        assert (eager[0][names.index("active")] == 0).any()
    assert c_graph == (7, 11, 7) and n_graph == n_eager


@pytest.mark.parametrize("scen", ["dl", "hs_adapt"])
def test_small_scenario_fits_run_their_kernels(cuda, scen):
    """600 sweeps: K1 and K5 once each per sweep, the truth recovered."""
    Y, St = _small_data()
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel="pallas", **_SCEN[scen]),
        run=RunConfig(burnin=150, mcmc=150, thin=2, num_chains=2),
        backend=BackendConfig(sse_mode="gram"))
    res = fit(Y, cfg, device=cuda)
    assert np.isfinite(res.Sigma).all() and res.stats.nonfinite_count == 0
    assert np.linalg.norm(res.Sigma - St) / np.linalg.norm(St) < 0.25
    expected = dict.fromkeys(res.kernel_launches, 0)
    expected.update({"chol_sample": 600, "sse_ps": 600,
                     "combine_panels": _combines(cfg.run)})
    assert res.kernel_launches == expected
    assert 1 <= res.stats.rank_min <= res.stats.rank_max <= 4


def test_a_capture_survives_event_waits_in_another_thread(cuda):
    """The write-behind writer's thread (and the stream drain's) waits on
    side-stream events while the chain captures its trips: under the
    default global capture mode such a wait invalidated the capture
    (CUBLAS_STATUS_INTERNAL_ERROR / cudaErrorStreamCaptureInvalidated in a
    resumed checkpointed fit).  A thread that waits on an event in a loop
    for the whole chunk must leave the graphed chain the eager chain."""
    import threading
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", lambda_kernel="pallas")
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.ones(1, device=cuda).add_(1)
        ev = torch.cuda.Event()
        ev.record(side)
    stop = threading.Event()
    waits = []

    def waiter():
        while not stop.is_set():
            ev.synchronize()
            waits.append(1)

    thread = threading.Thread(target=waiter)
    thread.start()
    try:
        graph, _, counts = _run_chains(cuda, cfg, graphs=True)
    finally:
        stop.set()
        thread.join(timeout=60)
    assert not thread.is_alive() and waits
    eager, _, _ = _run_chains(cuda, cfg, graphs=False)
    for c in range(2):
        for a, b in zip(eager[c], graph[c], strict=True):
            assert torch.equal(a, b)
    assert counts == (7, 11, 7)


def test_a_capture_survives_garbage_collected_inside_it(cuda, monkeypatch):
    """A dead reference cycle can hold an earlier runner's CUDA graphs (an
    exception's traceback holds a killed fit's runner), and Python's cyclic
    collector may run at any allocation - inside a capture too, where
    destroying them invalidated the capture (CUBLAS_STATUS_INTERNAL_ERROR
    in the card's killed-fit test run after another).  The runner turns
    automatic collection off while it captures: an earlier runner parked
    in a cycle as the capture begins, then allocations that would trigger
    collection, must leave the graphed chain the eager chain."""
    import gc
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", lambda_kernel="pallas")
    Y, _ = _small_data()
    Yd = torch.as_tensor(preprocess(Y, 4, seed=0).data, device=cuda)
    old = sampler.ChainRunner(TorchNoise(1, cuda), Yd, cfg, make_prior(cfg),
                              burnin=4, thin=2, unroll=2)
    old.run_chunk(0, old.init_chain(0), 12)
    assert old.captured > 0
    parked = [old]
    del old
    sweeps = sampler.ChainRunner._sweeps

    def sweeps_with_garbage(self, draws, pattern):
        if parked and torch.cuda.is_current_stream_capturing():
            cycle = [parked.pop()]
            cycle.append(cycle)
            del cycle
            for _ in range(5000):
                [[], []]
        return sweeps(self, draws, pattern)

    monkeypatch.setattr(sampler.ChainRunner, "_sweeps", sweeps_with_garbage)
    threshold = gc.get_threshold()
    gc.set_threshold(10)
    try:
        graph, _, counts = _run_chains(cuda, cfg, graphs=True)
    finally:
        gc.set_threshold(*threshold)
        monkeypatch.undo()
    assert not parked
    gc.collect()
    eager, _, _ = _run_chains(cuda, cfg, graphs=False)
    for c in range(2):
        for a, b in zip(eager[c], graph[c], strict=True):
            assert torch.equal(a, b)
    assert counts == (7, 11, 7)


# the last knobs: missing values on every Lambda path (bf16: the float32
# imputation inside a bf16 sweep, K4), the draw ring (with missing values
# under the plain estimator: no H)
_KNOBS = {"f32_missing": ({"lambda_kernel": "pallas"}, 0, 0.1),
          "bf16_missing": ({"compute_dtype": "bf16"}, 0, 0.1),
          "fused_missing": ({"lambda_kernel": "pallas-fused"}, 0, 0.1),
          "f32_draws": ({"lambda_kernel": "pallas"}, 9, 0.0),
          "plain_draws_missing": ({"lambda_kernel": "pallas",
                                   "estimator": "plain"}, 9, 0.1)}


@pytest.mark.parametrize("knob", sorted(_KNOBS))
def test_knob_graph_chain_equals_eager_chain_bitwise(cuda, knob):
    """Every leaf, the imputation sum and the draw ring included, of the
    graphed chain bitwise the eager chain's (38 sweeps in trips of 5,
    burn-in 11, thin 3: 9 saved draws fill the ring); the ring's slots
    all written, the completed data finite."""
    knobs, S, missing = _KNOBS[knob]
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", impute_missing=missing > 0, **knobs)
    eager, n_eager, _ = _run_chains(cuda, cfg, False, num_stored_draws=S,
                                    missing=missing)
    graph, n_graph, c_graph = _run_chains(cuda, cfg, True,
                                          num_stored_draws=S,
                                          missing=missing)
    n_ring = 0 if not S else 3 + (cfg.estimator == "scaled")
    for c in range(2):
        assert len(graph[c]) == 9 + n_ring + (missing > 0)
        for i, (a, b) in enumerate(zip(eager[c], graph[c], strict=True)):
            assert torch.equal(a, b), (c, i, float((a - b).abs().max()))
        if S:
            ring = graph[c][9]
            assert (ring.abs().sum(dim=(1, 2, 3)) > 0).all()
        if missing:
            assert torch.isfinite(graph[c][-1]).all()
    assert c_graph == (7, 11, 7) and n_graph == n_eager


def test_two_replays_of_one_pattern_land_in_two_slots(cuda):
    """Trips of one sweep, every sweep saved (burn-in 0, thin 1): the
    same captured graph replays for every trip after the first, and
    each replay writes the next ring slot - slot s holds the state after
    sweep s + 1, all six distinct."""
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      sse_mode="gram", lambda_kernel="pallas")
    Y, _ = _small_data()
    Yd = torch.as_tensor(preprocess(Y, 4, seed=0).data, device=cuda)
    runner = sampler.ChainRunner(TorchNoise(0, cuda), Yd, cfg,
                                 make_prior(cfg), burnin=0, thin=1,
                                 unroll=1, num_stored_draws=6)
    carry = runner.init_chain(0)
    after = []
    for _ in range(6):
        carry, _, _ = runner.run_chunk(0, carry, 1)
        after.append(carry.state.Lambda.clone())
    assert runner.captured == 1 and runner.replays == 5
    ring = carry.draws.Lambda
    for s in range(6):
        assert torch.equal(ring[s], after[s]), s
        for t in range(s):
            assert not torch.equal(ring[s], ring[t]), (s, t)


def test_small_missing_and_draws_fits_run_their_kernels(cuda):
    """A fit on data with 10% missing and a draw ring: K1 and K5 once per
    sweep, the truth recovered, Y_imputed finite with the observed
    entries the caller's, the ring chain-major."""
    Y, St = _small_data()
    Ym = Y.copy()
    mask = np.random.default_rng(3).random(Y.shape) < 0.1
    Ym[mask] = np.nan
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel="pallas"),
        run=RunConfig(burnin=150, mcmc=150, thin=2, num_chains=2,
                      store_draws=True),
        backend=BackendConfig(sse_mode="gram"))
    res = fit(Ym, cfg, device=cuda)
    assert np.isfinite(res.Sigma).all() and res.stats.nonfinite_count == 0
    assert np.linalg.norm(res.Sigma - St) / np.linalg.norm(St) < 0.25
    expected = dict.fromkeys(res.kernel_launches, 0)
    expected.update({"chol_sample": 600, "sse_ps": 600,
                     "combine_panels": _combines(cfg.run)})
    assert res.kernel_launches == expected
    assert np.isfinite(res.Y_imputed).all()
    np.testing.assert_array_equal(res.Y_imputed[~mask], Ym[~mask])
    assert res.draws["Lambda"].shape == (2, 75, 4, 24, 4)


@pytest.mark.parametrize("combine_chunks,posterior_sd", [(2, False),
                                                         (4, True)])
def test_chunked_combine_graph_equals_eager_bitwise(cuda, combine_chunks,
                                                    posterior_sd):
    """combine_chunks: the ranges are Python ints fixed at capture, so the
    graphed chain is the eager one bit for bit - the accumulators (and
    under posterior_sd the second moment) and the draw ring included - with
    the combine kernel launched once a range of each saved draw; and the
    chunked accumulators are the unchunked ones bit for bit (the kernel's
    arithmetic for an entry does not depend on the range it is in)."""
    cfg = ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                      lambda_kernel="pallas", combine_chunks=combine_chunks,
                      posterior_sd=posterior_sd)
    eager, n_eager, _ = _run_chains(cuda, cfg, graphs=False,
                                    num_stored_draws=9)
    graph, n_graph, c_graph = _run_chains(cuda, cfg, graphs=True,
                                          num_stored_draws=9)
    for c in range(2):
        for i, (a, b) in enumerate(zip(eager[c], graph[c], strict=True)):
            assert torch.equal(a, b), (c, i, float((a - b).abs().max()))
    assert n_graph == n_eager and c_graph[1] > 0
    # 38 iterations a chain, burn-in 11, thin 3: 9 saved draws a chain
    assert n_graph["combine_panels"] == 2 * 9 * combine_chunks
    flat, n_flat, _ = _run_chains(
        cuda, dataclasses.replace(cfg, combine_chunks=1), graphs=True,
        num_stored_draws=9)
    assert n_flat["combine_panels"] == 2 * 9
    n_leaves = len(state_leaf_names(cfg))
    for c in range(2):
        # the accumulator and, under posterior_sd, the second moment
        for i in (n_leaves, n_leaves + 3)[:1 + posterior_sd]:
            assert torch.equal(graph[c][i], flat[c][i]), (
                c, i, float((graph[c][i] - flat[c][i]).abs().max()))


@pytest.mark.parametrize("upload_dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kind", ["csr", "memmap"])
def test_chunked_lazy_upload_is_the_dense_upload(cuda, kind, upload_dtype,
                                                 tmp_path, monkeypatch):
    """A lazy ingest's upload, block of shards by block of shards into one
    device tensor, holds the dense upload's bytes (NaN included)."""
    from dcfm_tpu_torch.utils import preprocess as tpre
    monkeypatch.setattr(tpre.LazyShardData, "_CHUNK_ELEMS", 3 * 150 * 4)
    Y, _ = _small_data()
    Y = Y.copy()
    Y[np.abs(Y) < 0.3] = 0.0
    Y[3, 5] = np.nan
    if kind == "memmap":
        np.save(str(tmp_path / "Y.npy"), Y)
        inp = np.load(str(tmp_path / "Y.npy"), mmap_mode="r")
    else:
        rows, cols = np.nonzero((Y != 0) | np.isnan(Y))
        indptr = np.zeros(Y.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=Y.shape[0]), out=indptr[1:])
        inp = tpre.SparseMatrix(indptr, cols, Y[rows, cols], Y.shape)
    lazy = tpre.preprocess(inp, 24, seed=0)
    dense = tpre.preprocess(Y, 24, seed=0)
    assert lazy.data.shards_per_chunk == 3
    a = fetch.upload_data(lazy.data, upload_dtype, cuda)
    b = fetch.upload_data(dense.data, upload_dtype, cuda)
    assert a.device.type == "cuda" and a.dtype == torch.float32
    assert a.cpu().numpy().tobytes() == b.cpu().numpy().tobytes()


def test_streaming_fit_on_the_card_is_its_dense_twin(cuda, tmp_path):
    """A memmap fit on the card: K1 and K5 once per sweep, the panels the
    dense fit's bit for bit, Sigma kept packed."""
    Y, _ = _small_data()
    np.save(str(tmp_path / "Y.npy"), Y)
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel="pallas"),
        run=RunConfig(burnin=20, mcmc=20, thin=2),
        backend=BackendConfig(sse_mode="gram", fetch_dtype="quant8"))
    res = fit(np.load(str(tmp_path / "Y.npy"), mmap_mode="r"), cfg,
              device=cuda)
    ref = fit(Y, cfg, device=cuda)
    assert res.Sigma is None and ref.Sigma is not None
    np.testing.assert_array_equal(res._q8_panels, ref._q8_panels)
    np.testing.assert_array_equal(res._q8_scales, ref._q8_scales)
    assert res.kernel_launches["chol_sample"] == 40
    assert res.kernel_launches["sse_ps"] == 40


# ---- the outer layers: warm starts, the flight recorder, the profiler ----

def _outer_cfg(**run):
    return FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          lambda_kernel="pallas"),
        run=RunConfig(**({"burnin": 40, "mcmc": 40, "thin": 2,
                          "num_chains": 2, "sweep_unroll": 8,
                          "chunk_size": 20} | run)),
        backend=BackendConfig(sse_mode="gram", fetch_dtype="quant8"))


def _path_launches(cfg: FitConfig) -> dict:
    """K1 and K5 once a sweep of each chain, the combine kernel once a
    saved draw."""
    sweeps = cfg.run.num_chains * (cfg.run.burnin + cfg.run.mcmc)
    want = dict.fromkeys(cuda_lib.launch_counts(), 0)
    want.update(chol_sample=sweeps, sse_ps=sweeps,
                combine_panels=_combines(cfg.run))
    return want


def test_a_warm_started_graphed_fit_is_the_eager_one(cuda, tmp_path,
                                                     monkeypatch):
    """Appended rows: a warm start from a card fit's checkpoint, run as
    CUDA graphs and again on the eager runner - Sigma and every state
    leaf bit for bit (the grafted state reaches the captures from the
    device, never as a host value), K1 and K5 once per sweep."""
    from dcfm_tpu_torch import api
    from dcfm_tpu_torch.config import WarmStart
    from dcfm_tpu_torch.obs import run_events
    Y, St = _small_data()
    ck = str(tmp_path / "donor.npz")
    fit(Y[:120], dataclasses.replace(_outer_cfg(), checkpoint_path=ck),
        device=cuda)
    cfg = dataclasses.replace(_outer_cfg(burnin=10), warm_start=WarmStart(ck),
                              obs=str(tmp_path / "events"))
    graphed = fit(Y, cfg, device=cuda)
    monkeypatch.setattr(api, "ChainRunner", functools.partial(
        sampler.ChainRunner, graphs=False))
    eager = fit(Y, dataclasses.replace(cfg, obs="off"), device=cuda)
    assert graphed.graphs["replays"] > 0 and eager.graphs["replays"] == 0
    np.testing.assert_array_equal(graphed.Sigma, eager.Sigma)
    for a, b in zip(sampler.state_leaves(graphed.state),
                    sampler.state_leaves(eager.state), strict=True):
        assert torch.equal(a.cpu(), b.cpu())
    assert graphed.kernel_launches == eager.kernel_launches \
        == _path_launches(cfg)
    assert [e["decision"] for e in run_events(str(tmp_path / "events"))
            if e["event"] == "warm_start"] == ["warm"]
    assert np.linalg.norm(graphed.Sigma - St) / np.linalg.norm(St) < 0.25


def test_a_recorded_and_profiled_fit_on_the_card(cuda, tmp_path):
    """Recording and the profiler change no bit, though the profiled
    fit's graphs hold its stage timers' event nodes; the event log holds
    the fit's chunks and stream; the trace names K1 and K5 among its
    kernels and one api.chain.replay.* range per replay."""
    import json
    import os
    import re

    from dcfm_tpu_torch.obs import run_events
    Y, _ = _small_data()
    cfg = _outer_cfg()
    plain = fit(Y, dataclasses.replace(cfg, obs="off"), device=cuda)
    obs_dir, prof = str(tmp_path / "events"), str(tmp_path / "trace")
    res = fit(Y, dataclasses.replace(
        cfg, obs=obs_dir, backend=dataclasses.replace(
            cfg.backend, profile_dir=prof)), device=cuda)
    np.testing.assert_array_equal(res.Sigma, plain.Sigma)
    assert res.kernel_launches == _path_launches(cfg)
    kinds = [e["event"] for e in run_events(obs_dir)]
    assert kinds[0] == "fit_start" and kinds[-1] == "fit_done"
    assert kinds.count("chunk") == 4 and "stream_drain" in kinds
    (name,) = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(os.path.join(prof, name)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    assert any(re.search(r"chol_group_kernel(<\d+, \d+, false, true"
                         r"|ILi\d+ELi\d+ELb0ELb1)", k) for k in kernels)
    assert any("sse_ps_" in k for k in kernels)
    trips = [e for e in events
             if e.get("name", "").startswith("api.chain.replay.")
             and e.get("cat") == "user_annotation"]
    assert len(trips) == res.graphs["replays"]
    assert res.graphs["stage_samples"] > 0 and plain.graphs["stage_ms"] == {}


def _replay_times(events) -> dict:
    """Per graph replay of a Chrome trace, keyed by the range its launch
    ran in (api.chain.replay.save / .plain) and by whether it was the
    timed twin (the kind's first replay after the fit's start or a
    chunk's api.chain.boundary): (kernel ms summed, the ms from its first
    kernel's start to its last kernel's end)."""
    marks = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and (e["name"].startswith("api.chain.replay.")
                        or e["name"] == "api.chain.boundary"))
    kind = {}
    for e in events:
        if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e["name"]:
            for t0, t1, name in marks:
                if t0 <= e["ts"] <= t1 and name != "api.chain.boundary":
                    kind[e["args"]["correlation"]] = (name, t0)
    timed, seen = set(), set()
    for t0, _, name in marks:
        if name == "api.chain.boundary":
            seen.clear()
        elif name not in seen:
            seen.add(name)
            timed.add(t0)
    ops: dict = {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and corr in kind:
            ops.setdefault(corr, []).append((e["ts"], e["ts"] + e["dur"]))
    out: dict = {}
    for corr, ivs in ops.items():
        busy = sum(b - a for a, b in ivs) * 1e-3         # us -> ms
        span = (max(b for _, b in ivs) - min(a for a, _ in ivs)) * 1e-3
        name, t0 = kind[corr]
        out.setdefault((name, t0 in timed), []).append((busy, span))
    return out


def test_a_profiled_graphed_fit_times_every_stage_of_its_sweep(cuda,
                                                               tmp_path):
    """The trips' timed twins, replayed once a chunk and pattern under the
    profiler, time every stage of the path (MGP, Gram psi, K1) and the
    device time between them, the combine a saved draw.  At the north
    star's shapes (64 shards of 157, n = 500, K = 8) the stages of the
    timed replays add up to those replays' span on the device within
    10%: both run from the graph's first node to its last (the kernel sum
    the profiler reports leaves out the gaps between nodes; printed
    beside, with the untimed replays')."""
    import json
    import os

    rng = np.random.default_rng(3)
    L = rng.normal(size=(10048, 8)) / 8 ** 0.5
    Y = (rng.normal(size=(500, 8)) @ L.T
         + 0.2 * rng.normal(size=(500, 10048))).astype(np.float32)
    prof = str(tmp_path / "trace")
    cfg = FitConfig(
        model=ModelConfig(num_shards=64, factors_per_shard=8, rho=0.9),
        run=RunConfig(burnin=30, mcmc=30, thin=5, num_chains=2,
                      sweep_unroll=1, chunk_size=10),
        backend=BackendConfig(sse_mode="gram", profile_dir=prof))
    res = fit(Y, cfg, device=cuda)
    stages = res.graphs["stage_ms"]
    assert set(stages) == {"z_update", "x_update", "lambda_update",
                           "prior_update", "ps_update", "combine",
                           "health_trace", "other"}
    assert all(v > 0 for v in stages.values())
    # a sample per chunk, chain and pattern: 6 chunks of 2 chains, the
    # saving pattern met in the last 3
    assert res.graphs["stage_samples"] == 2 * 6 + 2 * 3
    (name,) = [f for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
    with open(os.path.join(prof, name)) as f:
        times = _replay_times(json.load(f)["traceEvents"])
    plain, save = "api.chain.replay.plain", "api.chain.replay.save"
    assert len(times[plain, True]) == 2 * 6
    assert len(times[save, True]) == 2 * 3
    # the timed replays, 18 sweeps and 6 saved draws: their stages'
    # device ms against the same replays' spans and kernel sums
    events = (18 * sum(v for k, v in stages.items() if k != "combine")
              + 6 * stages["combine"])
    span = sum(r[1] for r in times[plain, True] + times[save, True])
    busy = sum(r[0] for r in times[plain, True] + times[save, True])

    def mean(kind, timed, i):
        rows = times[kind, timed]
        return sum(r[i] for r in rows) / len(rows)
    print(f"timed replays: stages {events:.4f} ms, span {span:.4f} ms, "
          f"kernels {busy:.4f} ms; plain span timed "
          f"{mean(plain, True, 1):.4f} / untimed {mean(plain, False, 1):.4f}"
          f" ms, kernels {mean(plain, True, 0):.4f} / "
          f"{mean(plain, False, 0):.4f} ms; spans "
          f"{[round(r[1], 3) for r in times[plain, True]]} "
          f"{[round(r[1], 3) for r in times[save, True]]}; {stages}")
    assert abs(events - span) <= 0.10 * span


def test_a_profiled_dl_fit_times_and_counts_its_gig(cuda, tmp_path):
    """A graphed DL fit under the profiler times the GIG sampler as the
    stage ``gig`` inside ``prior_update`` and counts its draws over the
    timed replays only: G P K of phi's T and G P of tau a sweep, 64
    rounds each; the same fit without the profiler computes the same
    Sigma bit for bit and carries no ``gig`` key."""
    Y, _ = _small_data()
    cfg = FitConfig(
        model=ModelConfig(num_shards=4, factors_per_shard=4, rho=0.9,
                          prior="dl", lambda_kernel="pallas"),
        run=RunConfig(burnin=20, mcmc=20, thin=2, num_chains=2,
                      sweep_unroll=4, chunk_size=20),
        backend=BackendConfig(sse_mode="gram"))
    plain = fit(Y, cfg, device=cuda)
    res = fit(Y, dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, profile_dir=str(tmp_path / "trace"))), device=cuda)
    np.testing.assert_array_equal(res.Sigma, plain.Sigma)
    assert "gig" not in plain.graphs and plain.graphs["stage_ms"] == {}
    stages = res.graphs["stage_ms"]
    assert 0 < stages["gig"] < stages["prior_update"]
    # trips of 4 sweeps, one timed replay a chunk, chain and pattern
    G, P, K = 4, 24, 4
    draws = 4 * res.graphs["stage_samples"] * (G * P * K + G * P)
    got = res.graphs["gig"]
    assert got["draws"] == draws and got["rounds_evaluated"] == 64 * draws
    assert draws <= got["rounds_needed"] < got["rounds_evaluated"]
    assert 0 <= got["unaccepted"] < draws
    print(f"gig: {stages['gig']:.4f} of prior_update "
          f"{stages['prior_update']:.4f} ms a sweep; {got}")


def _serve_artifact(path, *, p=24, g=2, seed=0):
    """A small CRC'd artifact of random int8 mean and SD panels (symmetric
    diagonal panels, one all-zero input column), written without a fit;
    tests/test_torch_serve_server.py's make_artifact, here without its JAX
    imports."""
    from dcfm_tpu_torch.serve.artifact import write_artifact
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((40, p)).astype(np.float32)
    Y[:, 5] = 0.0
    pre = preprocess(Y, g)
    n_pairs, P = g * (g + 1) // 2, pre.shard_size
    q = rng.integers(-127, 128, size=(n_pairs, P, P)).astype(np.int8)
    scale = rng.uniform(0.5, 1.5, n_pairs).astype(np.float32)
    sd_q = rng.integers(1, 128, size=(n_pairs, P, P)).astype(np.int8)
    for r in range(g):
        d = r * g - (r * (r - 1)) // 2
        for panels in (q, sd_q):
            panels[d] = np.triu(panels[d]) + np.triu(panels[d], 1).T
    sd_scale = rng.uniform(0.5, 1.5, n_pairs).astype(np.float32)
    return write_artifact(path, mean_q8=q, mean_scale=scale, pre=pre,
                          sd_q8=sd_q, sd_scale=sd_scale).path


def test_the_card_engine_is_bitwise_the_cpu_engine(cuda, tmp_path):
    """Every answer of the engine whose panels live on the card equals
    the CPU engine's bit for bit, with the same cache counters under a
    budget that evicts, and the cache's bytes are device bytes."""
    from dcfm_tpu_torch.serve.engine import QueryEngine

    art = PosteriorArtifact.open(_serve_artifact(str(tmp_path / "a"), p=40,
                                                 g=4, seed=2))
    budget = 3 * art.P * art.P * 4
    dev = QueryEngine(art, cache_bytes=budget)       # the default: cuda
    host = QueryEngine(art, cache_bytes=budget, device="cpu")
    assert dev.device.type == "cuda"
    rng = np.random.default_rng(0)

    def bits(x):
        return np.asarray(x, np.float32).view(np.int32)

    for _ in range(5):
        qs = [(int(i), int(j), bool(d)) for i, j, d in zip(
            rng.integers(0, 40, 64), rng.integers(0, 40, 64),
            rng.integers(0, 2, 64))]
        np.testing.assert_array_equal(bits(dev.entries(qs)),
                                      bits(host.entries(qs)))
        rows, cols = rng.integers(0, 40, 9), rng.integers(0, 40, 11)
        for kind in ("mean", "sd"):
            for d in (True, False):
                np.testing.assert_array_equal(
                    bits(dev.block(rows, cols, kind=kind, destandardize=d)),
                    bits(host.block(rows, cols, kind=kind,
                                    destandardize=d)))
        i, j = (int(v) for v in rng.integers(0, 40, 2))
        assert bits(dev.entry(i, j, kind="sd")) == \
            bits(host.entry(i, j, kind="sd"))
        assert dev.interval(i, j, alpha=0.1) == host.interval(i, j,
                                                              alpha=0.1)
        np.testing.assert_array_equal(bits(dev.row(i)), bits(host.row(i)))
        assert dev.stats() == host.stats()
    assert dev.stats()["evictions"] > 0
    ref = art.assemble()
    np.testing.assert_array_equal(bits(dev.block(np.arange(40),
                                                 np.arange(40))), bits(ref))
    assert all(p.device.type == "cuda" for _, p in dev.cache.snapshot())


def test_one_request_served_from_the_card(cuda, tmp_path):
    import json
    import os
    import signal
    import subprocess
    import sys
    import urllib.request

    path = _serve_artifact(str(tmp_path / "a"), seed=3)
    ref = PosteriorArtifact.open(path).assemble()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "dcfm_tpu_torch.cli", "serve", path,
         "--port", "0"], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=repo)
    try:
        info = json.loads(proc.stdout.readline())
        card = f"cuda:0 ({torch.cuda.get_device_name(0)})"
        assert info["device"] == card
        with urllib.request.urlopen(info["serving"] + "/v1/entry?i=3&j=17",
                                    timeout=60) as r:
            assert np.float32(json.loads(r.read())["value"]) == ref[3, 17]
        with urllib.request.urlopen(info["serving"] + "/healthz",
                                    timeout=60) as r:
            assert json.loads(r.read())["device"] == card
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err
