"""Whole fits of the PyTorch port through the mixed-precision sweep
(``compute_dtype="bf16"``, kernel K4 for the Lambda update), the bf16
combine (``combine_dtype="bfloat16"``) and the fused Lambda update
(``lambda_kernel="pallas-fused"``, kernel K2), on the CPU where each
kernel runs its plain PyTorch version: against the JAX package's fits of
the same knobs, and the bf16 fit against the port's own float32 Monte
Carlo spread (the JAX package's accuracy contract, tests/test_precision.py).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests.conftest import make_synthetic  # noqa: E402

import dcfm_tpu  # noqa: E402
from dcfm_tpu_torch import (  # noqa: E402
    BackendConfig, FitConfig, ModelConfig, RunConfig, fit)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Launch-bound fits: one intra-op thread per test worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel_frob(A, B):
    return float(np.linalg.norm(A - B) / np.linalg.norm(B))


# tests/test_e2e.py's twin-parity shape, as in tests/test_torch_fit.py
TWIN = dict(g=2, K=3, rho=0.7, burnin=400, mcmc=400)


@functools.lru_cache(maxsize=None)
def _twin_y():
    return make_synthetic(120, 48, 3, seed=5)[0]


def _pair(compute_dtype="f32", lambda_kernel="auto", combine_dtype="float32"):
    """The same config for both packages at the twin shape."""
    model = dict(num_shards=TWIN["g"], factors_per_shard=TWIN["K"],
                 rho=TWIN["rho"], lambda_kernel=lambda_kernel,
                 combine_dtype=combine_dtype)
    run = dict(burnin=TWIN["burnin"], mcmc=TWIN["mcmc"], seed=0)
    backend = dict(compute_dtype=compute_dtype, sse_mode="gram")
    return (FitConfig(model=ModelConfig(**model), run=RunConfig(**run),
                      backend=BackendConfig(**backend)),
            dcfm_tpu.FitConfig(model=dcfm_tpu.ModelConfig(**model),
                               run=dcfm_tpu.RunConfig(**run),
                               backend=dcfm_tpu.BackendConfig(**backend)))


@pytest.mark.parametrize("compute_dtype,lambda_kernel", [
    ("bf16", "auto"), ("f32", "pallas-fused")])
def test_parity_with_jax_fit(compute_dtype, lambda_kernel):
    """The port's bf16 fit (K4) and fused fit (K2) against the JAX
    package's fits of the same knobs (its Pallas kernels in interpret mode
    on the CPU): different RNG streams, same model, so the twin band."""
    Y = _twin_y()
    cfg, jcfg = _pair(compute_dtype, lambda_kernel)
    res = fit(Y, cfg, device="cpu")
    assert res.stats.nonfinite_count == 0 and np.isfinite(res.Sigma).all()
    assert _rel_frob(res.Sigma, dcfm_tpu.fit(Y, jcfg).Sigma) < 0.05


def test_bf16_error_inside_f32_mc_band():
    """tests/test_precision.py's rule on the port: four float32 seeds give
    the chain-to-chain spread of the rel-Frobenius error against the
    truth; the bf16 fit must land inside that band widened by half its
    width."""
    Y, St = make_synthetic(n=120, p=48, k_true=3, seed=11)

    def run(dtype, seed):
        cfg = FitConfig(
            model=ModelConfig(num_shards=2, factors_per_shard=3, rho=0.8),
            run=RunConfig(burnin=150, mcmc=150, thin=1, seed=seed),
            backend=BackendConfig(compute_dtype=dtype))
        return _rel_frob(fit(Y, cfg, device="cpu").Sigma, St)

    f32_errs = np.array([run("f32", s) for s in range(4)])
    bf16_err = run("bf16", 0)
    width = max(f32_errs.max() - f32_errs.min(), 1e-3)
    lo, hi = f32_errs.min() - 0.5 * width, f32_errs.max() + 0.5 * width
    assert lo <= bf16_err <= hi, (
        f"bf16 err {bf16_err:.4f} outside f32 MC band "
        f"[{lo:.4f}, {hi:.4f}] (f32 samples {np.round(f32_errs, 4)})")


def test_bf16_combine_leaves_the_chain_alone():
    """combine_dtype="bfloat16" changes only the accumulated panels: the
    chain (its traces) is bitwise the float32 run's, and Sigma moves by
    bf16 rounding of the block products, not more."""
    Y = _twin_y()
    f32 = fit(Y, _pair()[0], device="cpu")
    b16 = fit(Y, _pair(combine_dtype="bfloat16")[0], device="cpu")
    np.testing.assert_array_equal(b16.traces, f32.traces)
    assert 0 < _rel_frob(b16.Sigma, f32.Sigma) < 2e-3   # 1.4e-4 measured
