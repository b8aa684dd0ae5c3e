"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.  The
kernels' plain versions (what a CPU tensor runs) are held against the
Pallas kernels in interpret mode and against the JAX package's own plain
paths (K1 and K5 here, K2, K3 and K4 below); the Gaussian samplers against their JAX twins on the same noise;
the Gamma samplers by moments.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dcfm_tpu.ops import batched_solve as jbs  # noqa: E402
from dcfm_tpu.ops.gaussian import (  # noqa: E402
    mvn_mean_precision, sample_mvn_precision_batched,
    sample_mvn_precision_shared)
from dcfm_tpu.ops.pallas_gaussian import (  # noqa: E402
    chol_sample_batched_pallas, lam_update_pallas)
from dcfm_tpu.ops.sse_gamma import gram_sse_ps  # noqa: E402
from dcfm_tpu_torch.noise import TorchNoise  # noqa: E402
from dcfm_tpu_torch.ops import batched_solve as tbs  # noqa: E402
from dcfm_tpu_torch.ops import cuda_lib  # noqa: E402
from dcfm_tpu_torch.ops import gaussian as tg  # noqa: E402
from dcfm_tpu_torch.ops.chol_sample import chol_sample  # noqa: E402
from dcfm_tpu_torch.ops.lam_update import lam_update  # noqa: E402
from dcfm_tpu_torch.ops.gamma import (  # noqa: E402
    gamma_rate, gamma_rate_half_integer, gamma_unit_static)
from dcfm_tpu_torch.ops.sse_gamma import sse_ps  # noqa: E402


def _spd(rng, B, K):
    A = rng.standard_normal((B, K, K)).astype(np.float32)
    return A @ np.transpose(A, (0, 2, 1)) + 2.0 * np.eye(K, dtype=np.float32)


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# K1: the Lambda update's factor-solve-sample
# ---------------------------------------------------------------------------

# K = 3, 5, 7, 9, 13 and 15 leave lanes of the card kernel's W-lane group
# idle (W the power of two >= K); the card holds the kernel against this
# plain version there, so the plain version is held against JAX there first
@pytest.mark.parametrize("B,K", [(700, 8), (1, 5), (513, 16), (64, 3),
                                 (33, 7), (65, 9), (129, 13), (97, 15)])
def test_chol_sample_plain_matches_pallas_and_unrolled(B, K):
    rng = np.random.default_rng(B + K)
    Q = _spd(rng, B, K)
    b = rng.standard_normal((B, K)).astype(np.float32)
    key = jax.random.key(K)
    Zn = np.array(jax.random.normal(key, (B, K), jnp.float32))
    before = cuda_lib.launch_counts()
    out = chol_sample(torch.as_tensor(Q), torch.as_tensor(b),
                      torch.as_tensor(Zn)).numpy()
    assert cuda_lib.launch_counts() == before      # a CPU tensor: plain path
    pal = _np(chol_sample_batched_pallas(jnp.asarray(Q), jnp.asarray(b),
                                         jnp.asarray(Zn), interpret=True))
    unrolled = jax.jit(functools.partial(sample_mvn_precision_batched,
                                         impl="unrolled"))
    # the same key on purpose: it draws the Zn handed to the port above
    unr = _np(unrolled(key,  # dcfm: ignore[DCFM101] - same Zn as the port
                       jnp.asarray(Q), jnp.asarray(b)))
    # the plain version repeats the unrolled recurrence op for op (only
    # XLA's fusion differs); the Pallas kernel also multiplies by 1/L_jj in
    # its backward solves.  Q = AA' + 2I is well conditioned, so both stay
    # at float32 rounding: measured max |diff| 4.2e-7 against the unrolled
    # path and 8.3e-7 against the kernel at |x| <= 2.4, so 1e-5 keeps
    # 10x headroom
    np.testing.assert_allclose(out, unr, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, pal, rtol=1e-5, atol=1e-5)


def test_chol_sample_wrapper_refuses_bad_input():
    Q = torch.eye(4).expand(3, 4, 4)
    b = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        chol_sample(Q, b, b)
    with pytest.raises(TypeError, match="float32"):
        chol_sample(Q.contiguous().double(), b.double(), b.double())  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    with pytest.raises(ValueError, match="range"):
        chol_sample(torch.eye(17).expand(2, 17, 17).contiguous(),
                    torch.zeros((2, 17)), torch.zeros((2, 17)))
    with pytest.raises(ValueError, match=r"\(3, 4\)"):
        chol_sample(Q.contiguous(), torch.zeros((3, 5)), b)


_F64 = dict(dtype=torch.float64)  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusals under test


@pytest.mark.parametrize("shapes,kw,exc,msg", [
    (((4, 4), (4, 4), (4, 4)), {}, ValueError,
     "Q must be (B, K, K), got (4, 4)"),
    (((2, 3, 4), (2, 3), (2, 3)), {}, ValueError,
     "Q must be (B, K, K), got (2, 3, 4)"),
    (((2, 17, 17), (2, 17), (2, 17)), {}, ValueError,
     "K=17 outside the kernel's range 1..16"),
    (((2, 0, 0), (2, 0), (2, 0)), {}, ValueError,
     "K=0 outside the kernel's range 1..16"),
    (((3, 4, 4), (3, 5), (3, 4)), {}, ValueError,
     "b must be (3, 4), got (3, 5)"),
    (((3, 4, 4), (3, 4), (4, 4)), {}, ValueError,
     "z must be (3, 4), got (4, 4)"),
    (((3, 4, 4), (3, 4), (3, 4)), {"Q": _F64}, TypeError,
     "Q must be float32, got torch.float64"),
    (((3, 4, 4), (3, 4), (3, 4)), {"z": _F64}, TypeError,
     "z must be float32, got torch.float64"),
    (((3, 4, 4), (3, 4), (3, 4)), {"b": dict(device="meta")}, ValueError,
     "b on meta, Q on cpu"),
    (((3, 4, 4), (3, 4), (3, 4)), {"z": dict(transpose=True)}, ValueError,
     "z must be contiguous"),
    (((3, 4, 4), (3, 4), (3, 4)),
     {n: dict(device="meta") for n in "Qbz"}, ValueError,
     "the kernels run on cpu or cuda, not meta"),
])
def test_check_systems_refusals_name_the_fault(shapes, kw, exc, msg):
    """Every refusal of the K1/K4/K3 wrappers' input check, with its exact
    message: the combined fast test hands each fault to the detailed one."""
    from dcfm_tpu_torch.ops.chol_sample import check_systems
    ts = {}
    for name, shape in zip("Qbz", shapes):
        opt = dict(kw.get(name, {}))
        if opt.pop("transpose", False):
            ts[name] = torch.zeros(shape[::-1], **opt).T
        else:
            ts[name] = torch.zeros(shape, **opt)
    wrappers = [check_systems, chol_sample]
    if ts["Q"].dim() != 3 or ts["Q"].shape[-1] <= 16:  # else torch.linalg
        wrappers.append(tbs.chol_solve_sample_batched)
    for fn in wrappers:
        with pytest.raises(exc) as got:
            fn(ts["Q"], b=ts["b"], z=ts["z"])
        assert str(got.value) == msg, fn.__name__


def test_check_systems_accepts_what_the_kernels_take():
    from dcfm_tpu_torch.ops.chol_sample import check_systems
    for K in (1, 5, 16):
        Q = torch.zeros((3, K, K))
        assert check_systems(Q, b=torch.zeros((3, K)),
                             z=torch.zeros((3, K))) is None
        assert check_systems(Q, b=torch.zeros((3, K))) is None
        assert check_systems(torch.zeros((0, K, K)),
                             b=torch.zeros((0, K))) is None


def test_linalg_sampler_matches_unrolled():
    """The K > 16 route (torch.linalg) samples the same function."""
    rng = np.random.default_rng(4)
    Q = torch.as_tensor(_spd(rng, 50, 6))
    b = torch.as_tensor(rng.standard_normal((50, 6)).astype(np.float32))
    z = torch.as_tensor(rng.standard_normal((50, 6)).astype(np.float32))
    torch.testing.assert_close(tg.sample_mvn_precision_linalg(Q, b, z),
                               chol_sample(Q, b, z), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K4 / K3: the batched solves of the bf16 sweep; K2: the fused Lambda update
# ---------------------------------------------------------------------------

# Tolerance of the three plain versions against the Pallas kernels: the
# plain version repeats the kernel's recurrence op for op, so only XLA's
# fusion and FMA choices differ.  Over 5 seeds at each K in {1, 4, 8, 16}
# the worst max |diff| was 9.0e-7 of the largest |x| (K2 at K = 16; K4
# 4.0e-7, K3 6.3e-7), so 1e-5 absolute + 1e-5 relative at |x| <= 5 keeps
# 10x headroom.
_SOLVE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("K", [1, 4, 8, 16, 3, 5, 7, 9, 13, 15])
def test_chol_solve_sample_plain_matches_pallas_and_unrolled(K):
    rng = np.random.default_rng(40 + K)
    B = 701                                    # not a multiple of the tile
    Q = _spd(rng, B, K)
    b, z = (rng.standard_normal((B, K)).astype(np.float32) for _ in range(2))
    before = cuda_lib.launch_counts()
    out = tbs.chol_solve_sample_batched(
        *(torch.as_tensor(a) for a in (Q, b, z))).numpy()
    assert cuda_lib.launch_counts() == before      # a CPU tensor: plain path
    for impl in ("pallas-interpret", "unrolled"):
        ref = _np(jbs.chol_solve_sample_batched(Q, b, z, impl=impl))
        np.testing.assert_allclose(out, ref, err_msg=impl, **_SOLVE_TOL)


@pytest.mark.parametrize("K", [1, 4, 8, 16, 3, 5, 7, 13])
def test_cho_solve_plain_matches_pallas(K):
    rng = np.random.default_rng(60 + K)
    B = 701
    Q = _spd(rng, B, K)
    b = rng.standard_normal((B, K)).astype(np.float32)
    out = tbs.cho_solve_batched(torch.as_tensor(Q), torch.as_tensor(b))
    ref = _np(jbs.cho_solve_batched(Q, b, impl="pallas-interpret"))
    np.testing.assert_allclose(out.numpy(), ref, **_SOLVE_TOL)


def test_batched_solves_above_the_kernel_bound_match_lax():
    """K > 16 goes through torch.linalg, as the JAX package's lax branch:
    LAPACK and XLA factor and solve in other orders (float32 rounding)."""
    rng = np.random.default_rng(7)
    Q = _spd(rng, 9, 20)
    b, z = (rng.standard_normal((9, 20)).astype(np.float32) for _ in range(2))
    t = [torch.as_tensor(a) for a in (Q, b, z)]
    np.testing.assert_allclose(
        tbs.chol_solve_sample_batched(*t).numpy(),
        _np(jbs.chol_solve_sample_batched(Q, b, z, impl="lax")),
        rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        tbs.cho_solve_batched(t[0], t[1]).numpy(),
        _np(jbs.cho_solve_batched(Q, b, impl="lax")), rtol=1e-4, atol=1e-4)


def test_cho_solve_shared_matches_jax():
    rng = np.random.default_rng(8)
    Q = _spd(rng, 1, 6)[0]
    B = rng.standard_normal((40, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tbs.cho_solve_shared(torch.as_tensor(Q), torch.as_tensor(B)).numpy(),
        _np(jbs.cho_solve_shared(jnp.asarray(Q), jnp.asarray(B))),
        rtol=1e-5, atol=1e-5)


def _lam_operands(rng, G, P, K):
    """The fused update's operands as the sweep forms them: E = eta'eta
    (SPD), plam > 0, ps > 0 (the JAX package's own test distribution)."""
    A = rng.standard_normal((G, K, K)).astype(np.float32)
    E = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(K, dtype=np.float32)
    plam = (rng.gamma(2.0, 1.0, (G, P, K)) + 0.1).astype(np.float32)
    ps = rng.gamma(3.0, 0.5, (G, P)).astype(np.float32)
    EYt, Zn = (rng.standard_normal((G, P, K)).astype(np.float32)
               for _ in range(2))
    return E, plam, ps, EYt, Zn


# K = 3, 5, 7 and 13 leave lanes of the card kernel's W-lane group idle;
# G = 1 is a single shard and P = 5 fewer rows than one block of groups
# holds.  The card holds the kernel against this plain version at those
# shapes, so the plain version is held against JAX there first.
@pytest.mark.parametrize("G,P,K", [(3, 157, 1), (3, 157, 4), (3, 157, 8),
                                   (3, 157, 16), (3, 157, 3), (3, 157, 5),
                                   (3, 157, 7), (3, 157, 13), (1, 157, 8),
                                   (2, 5, 8), (1, 5, 13)])
def test_lam_update_plain_matches_pallas(G, P, K):
    """P = 157 is not a multiple of the Pallas kernel's 256-row tile, so
    its padded rows are exercised (and must not leak into the result).
    Tolerance _SOLVE_TOL (1e-5 + 1e-5 |x|): the plain version repeats the
    kernel's recurrence op for op, only XLA's fusion and FMA choices
    differ."""
    rng = np.random.default_rng(80 + K)
    ops = _lam_operands(rng, G, P, K)
    before = cuda_lib.launch_counts()
    out = lam_update(*(torch.as_tensor(a) for a in ops)).numpy()
    assert cuda_lib.launch_counts() == before
    ref = _np(lam_update_pallas(*(jnp.asarray(a) for a in ops),
                                interpret=True))
    np.testing.assert_allclose(out, ref, **_SOLVE_TOL)


def test_lam_update_plain_equals_k1_plain_on_the_formed_precision():
    """Forming Q_j = diag(plam_j) + ps_j E in the recurrence changes no
    operation of K1's: the two plain versions agree bitwise."""
    from dcfm_tpu_torch.ops.chol_sample import chol_sample_plain
    E, plam, ps, EYt, Zn = (torch.as_tensor(a) for a in _lam_operands(
        np.random.default_rng(3), 2, 33, 5))
    G, P, K = plam.shape
    Q = torch.diag_embed(plam) + ps[..., None, None] * E[:, None]
    x = chol_sample_plain(Q.reshape(G * P, K, K),
                          (ps[..., None] * EYt).reshape(G * P, K),
                          Zn.reshape(G * P, K)).reshape(G, P, K)
    assert torch.equal(lam_update(E, plam, ps, EYt, Zn), x)


def test_new_wrappers_refuse_bad_input():
    Q = torch.eye(4).expand(3, 4, 4)
    b = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        tbs.chol_solve_sample_batched(Q, b, b)
    with pytest.raises(TypeError, match="float32"):
        tbs.cho_solve_batched(Q.contiguous().double(), b.double())  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    E, plam, ps, EYt, Zn = (torch.as_tensor(a) for a in _lam_operands(
        np.random.default_rng(0), 2, 5, 3))
    with pytest.raises(ValueError, match="contiguous"):
        lam_update(E, plam, ps, EYt.transpose(0, 1).contiguous()
                   .transpose(0, 1), Zn)
    with pytest.raises(TypeError, match="float32"):
        lam_update(E, plam, ps.double(), EYt, Zn)  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    with pytest.raises(ValueError, match=r"\(2, 5\)"):
        lam_update(E, plam, ps[:, :4], EYt, Zn)
    with pytest.raises(ValueError, match="range"):
        lam_update(torch.eye(17).expand(2, 17, 17).contiguous(),
                   torch.ones((2, 5, 17)), torch.ones((2, 5)),
                   torch.ones((2, 5, 17)), torch.ones((2, 5, 17)))


# ---------------------------------------------------------------------------
# K5: the Gram SSE and the psi rate
# ---------------------------------------------------------------------------

def _sse_operands(rng, B, K, n=30):
    """Gram operands of a real fit: eta (n, K), Y (n, B), so the SSE is
    a residual sum of squares; the first 8 features are fit almost
    perfectly, which drives the three-term SSE to the clamp.  Above K = 8
    the loadings shrink by sqrt(8 / K), so Y'Y (and with it the ulp that
    the absolute tolerances below are sized to) stays what it is at K = 8."""
    eta = rng.standard_normal((n, K)).astype(np.float32)
    Lam = rng.standard_normal((B, K)).astype(np.float32)
    if K > 8:
        Lam *= np.float32(np.sqrt(8.0 / K))
    Y = eta @ Lam.T + rng.standard_normal((n, B)).astype(np.float32)
    Y[:, :8] = eta @ Lam[:8].T
    E = eta.T @ eta
    return (Lam, Lam @ E, (eta.T @ Y).T.copy(),
            np.sum(Y * Y, axis=0), rng.gamma(n / 2 + 1, 1.0, B)
            .astype(np.float32))


# K = 24 is above the card kernel's fixed-K range (its run-time-K route);
# B = 1, 129 and 700 are ragged against its block
@pytest.mark.parametrize("B,K", [(700, 8), (1, 5), (64, 3), (1, 1), (129, 1),
                                 (700, 4), (129, 4), (1, 16), (129, 16),
                                 (700, 16), (1, 24), (129, 24), (700, 24)])
def test_sse_ps_plain_matches_pallas_and_plain(B, K):
    rng = np.random.default_rng(B * K)
    ops = _sse_operands(rng, B, K)
    ps, sse = sse_ps(*(torch.as_tensor(a) for a in ops), bs=0.3)
    ps, sse = ps.numpy(), sse.numpy()
    assert np.all(sse >= 0)
    for impl in ("pallas-interpret", "plain"):
        ps_j, sse_j = gram_sse_ps(*(jnp.asarray(a) for a in ops), bs=0.3,
                                  impl=impl)
        # three O(Y'Y) terms cancel: the difference is a few ulp of
        # Y'Y (~n*K here), 1e-4 absolute; ps inherits it relatively
        np.testing.assert_allclose(sse, _np(sse_j), rtol=1e-5, atol=1e-4)
        # at the clamp (sse ~ 0) the sse tolerance reaches ps through the
        # rate as 0.5 * 1e-4 / bs = 1.7e-4 relative; the longer sums of
        # K > 8 get there (1.3e-4 measured at K = 24), the others stay
        # inside 1e-4
        np.testing.assert_allclose(ps, _np(ps_j),
                                   rtol=1e-4 if K <= 8 else 2e-4, atol=1e-6)


@pytest.mark.parametrize("K,lanes", [(8, 2), (16, 4), (16, 2), (4, 1)])
def test_sse_lanewise_summation_stays_inside_the_card_tolerance(K, lanes):
    """A card kernel that splits a feature's K products over `lanes` lanes
    (each summing K / lanes products in increasing k, the partial sums
    combined pairwise, as a butterfly of warp shuffles does) changes the
    order of the float32 sums only: emulated in numpy, its SSE stays inside
    4 K eps |terms| of the increasing-k order, the tolerance the smoke test
    applies to the card kernel.  (The kernel that was kept sums in
    increasing k; the other order was timed and lost.)"""
    rng = np.random.default_rng(K * lanes)
    Lam, M, EYt, yty, _ = _sse_operands(rng, 4096, K)
    f32 = np.float32

    def dots(order):
        quad, dot2 = order(Lam * M), order(Lam * EYt)
        return yty - f32(2.0) * dot2 + quad

    def increasing(t):
        acc = t[:, 0]
        for j in range(1, t.shape[1]):
            acc = (acc + t[:, j]).astype(f32)
        return acc

    def lanewise(t):
        parts = [increasing(c) for c in np.split(t, lanes, axis=1)]
        while len(parts) > 1:           # shfl_xor at distance len / 2
            half = len(parts) // 2
            parts = [(parts[i] + parts[i + half]).astype(f32)
                     for i in range(half)]
        return parts[0]

    a, b = dots(increasing), dots(lanewise)
    scale = (np.abs(yty) + 2 * np.abs(Lam * EYt).sum(-1)
             + np.abs(Lam * M).sum(-1))
    tol = 4 * K * np.finfo(f32).eps * scale
    assert np.all(np.abs(a - b) <= tol)
    if lanes > 1:
        assert np.any(a != b)           # the order does change the bits


def test_sse_ps_clamps_overshoot_to_zero():
    Lam = torch.ones((4, 2))
    M = torch.ones((4, 2))
    EYt = torch.ones((4, 2))
    yty = torch.tensor([2.0 - 1e-3, 2.0, 3.0, float("nan")])
    ps, sse = sse_ps(Lam, M, EYt, yty, torch.ones(4), bs=0.5)
    assert sse[0] == 0 and sse[1] == 0 and sse[2] == 1.0
    assert torch.isnan(sse[3]) and torch.isnan(ps[3])   # NaN is not hidden
    assert ps[0] == 2.0


# ---------------------------------------------------------------------------
# the shared-precision sampler of the Z and X updates
# ---------------------------------------------------------------------------

def test_shared_sampler_matches_jax():
    rng = np.random.default_rng(7)
    K, n = 5, 40
    Q = _spd(rng, 1, K)[0]
    B = rng.standard_normal((n, K)).astype(np.float32)
    key = jax.random.key(3)
    Zn = np.array(jax.random.normal(key, (n, K), jnp.float32))
    mean = tg.sample_mvn_precision_shared(
        torch.zeros((n, K)), torch.as_tensor(Q), torch.as_tensor(B))
    np.testing.assert_allclose(
        mean.numpy(), _np(mvn_mean_precision(jnp.asarray(Q), jnp.asarray(B))),
        rtol=1e-5, atol=1e-5)
    draw = tg.sample_mvn_precision_shared(
        torch.as_tensor(Zn), torch.as_tensor(Q), torch.as_tensor(B))
    # LAPACK (torch) and XLA's triangular solves at float32 rounding
    ref = sample_mvn_precision_shared(
        key,  # dcfm: ignore[DCFM101] - draws the Zn handed to the port above
        jnp.asarray(Q), jnp.asarray(B))
    np.testing.assert_allclose(draw.numpy(), _np(ref), rtol=1e-5, atol=1e-5)


def test_shared_sampler_batches_over_shards():
    rng = np.random.default_rng(8)
    Q = torch.as_tensor(_spd(rng, 3, 4))
    B = torch.as_tensor(rng.standard_normal((3, 20, 4)).astype(np.float32))
    Zn = torch.as_tensor(rng.standard_normal((3, 20, 4)).astype(np.float32))
    batched = tg.sample_mvn_precision_shared(Zn, Q, B)
    for g in range(3):
        torch.testing.assert_close(
            batched[g], tg.sample_mvn_precision_shared(Zn[g], Q[g], B[g]),
            rtol=1e-6, atol=1e-6)


def test_cholesky_of_a_non_spd_matrix_is_nan():
    """A failed factorization poisons the draw (the chain's health counter
    sees it) instead of raising mid-chain."""
    Q = torch.tensor([[1.0, 2.0], [2.0, 1.0]])
    assert torch.isnan(tg.sample_mvn_precision_shared(
        torch.zeros((3, 2)), Q, torch.ones((3, 2)))).all()


# ---------------------------------------------------------------------------
# Gamma samplers by moments (the psi-stage shapes, as the JAX tests do)
# ---------------------------------------------------------------------------

def _draws(seed):
    return TorchNoise(seed, "cpu").sweep(0, seed)


@pytest.mark.parametrize("a", [3.0, 21.5, 101.0, 2.3])
def test_gamma_unit_static_moments(a):
    """Exp-sum (+ half chi-square) construction, and the standard-Gamma
    fallback at a fractional shape: mean and variance both equal a,
    within 5 standard errors."""
    N = 40_000
    g = gamma_unit_static(_draws(int(a * 10)), 5, a, (N,)).numpy()
    assert np.all(g > 0)
    assert abs(g.mean() - a) < 5 * np.sqrt(a / N), (g.mean(), a)
    assert abs(g.var() - a) < 5 * np.sqrt(2.0 / N) * (a + 1), (g.var(), a)


@pytest.mark.parametrize("shape,rate", [(1.0, 0.3), (1.5, 2.0), (2.0, 1.0),
                                        (2.7, 0.5), (251.0, 40.0)])
def test_gamma_rate_moments(shape, rate):
    """The exponential, chi-square and standard-Gamma routes: mean
    shape/rate, variance shape/rate^2."""
    N = 40_000
    g = gamma_rate(_draws(7), 4, shape, rate, sample_shape=(N,)).numpy()
    mean, var = shape / rate, shape / rate ** 2
    assert np.all(g > 0)
    assert abs(g.mean() - mean) < 5 * np.sqrt(var / N)
    assert abs(g.var() - var) < 5 * np.sqrt(2.0 / N) * var * (
        1 + 3 / shape) ** 0.5


def test_gamma_rate_half_integer_moments():
    """Elementwise half-integer shapes (the MGP psi draw): k/2 for k in
    {3, 4}, masked from max_twice = 4 normals per element."""
    N = 40_000
    twice = torch.tensor([3, 4]).repeat(N)
    rate = torch.tensor([1.5, 0.5]).repeat(N)
    g = gamma_rate_half_integer(_draws(11), 4, twice, rate,
                                max_twice=4).numpy().reshape(N, 2)
    for j, (s, r) in enumerate([(1.5, 1.5), (2.0, 0.5)]):
        assert abs(g[:, j].mean() - s / r) < 5 * np.sqrt(s / r ** 2 / N)


def test_noise_streams_are_keyed_not_sequential():
    """A draw depends on (seed, chain, iteration, site) only: the order in
    which sites are asked for, and what else was drawn, change nothing."""
    a = TorchNoise(3, "cpu").sweep(1, 9)
    b = TorchNoise(3, "cpu").sweep(1, 9)
    za = a.normal(1, (4, 3))
    b.normal(2, (10,))
    torch.testing.assert_close(b.normal(1, (4, 3)), za, rtol=0, atol=0)
    c = TorchNoise(3, "cpu").sweep(1, 10)
    assert not torch.equal(c.normal(1, (4, 3)), za)
    assert not torch.equal(TorchNoise(3, "cpu").sweep(2, 9).normal(1, (4, 3)),
                           za)
