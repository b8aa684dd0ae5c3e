"""The combine's wrapper and plain version (dcfm_tpu_torch/ops/combine.py)
on the CPU: the plain version bitwise the arithmetic the port's combine
ran before the combine kernel (two batched products into a temporary, the
diagonal pairs' 1/ps, then the adds), the wrapper's refusals, the launch
counter, and ``sampler.add_panels``' choice between the float32 wrapper
and the bf16 GEMMs.  The kernel itself is held to the plain version on the
card (tests/test_torch_gpu.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dcfm_tpu_torch.models import sampler  # noqa: E402
from dcfm_tpu_torch.models import state as tstate  # noqa: E402
from dcfm_tpu_torch.models.conditionals import (  # noqa: E402
    covariance_panels, cross_moments)
from dcfm_tpu_torch.ops import combine as comb  # noqa: E402
from dcfm_tpu_torch.ops import cuda_lib  # noqa: E402

# g = 4 shards: 10 upper pairs padded to 12, the padding aliasing (0, 0)
G, P, K, N, RHO = 4, 6, 3, 12, 0.7


def _operands(seed=3):
    rng = np.random.default_rng(seed)
    rows, cols = tstate.packed_pair_indices(G)
    Q = rows.size
    return dict(
        Lam=torch.as_tensor(rng.standard_normal((G, P, K)).astype(np.float32)),
        ps=torch.as_tensor(rng.gamma(2.0, 1.0, (G, P)).astype(np.float32)),
        eta=torch.as_tensor(rng.standard_normal((G, N, K)).astype(np.float32)),
        rows=torch.as_tensor(rows, dtype=torch.long),
        cols=torch.as_tensor(cols, dtype=torch.long),
        acc=torch.as_tensor(
            rng.standard_normal((Q, P, P)).astype(np.float32)),
        sq=torch.as_tensor(rng.gamma(2.0, 1.0, (Q, P, P)).astype(np.float32)))


def _before_the_kernel(acc, sq, Lam, ps, rho, rows, cols, eta):
    """The float32 combine of one range as the port ran it before the
    combine kernel: covariance_panels' body, then the adds."""
    Lam_r, Lam_c = Lam[rows], Lam[cols]
    diag = rows == cols
    if eta is not None:
        H = cross_moments(eta)[rows, cols]
        blocks = torch.matmul(torch.matmul(Lam_r, H), Lam_c.transpose(-1, -2))
    else:
        blocks = torch.matmul(Lam_r, Lam_c.transpose(-1, -2))
        scale = torch.where(diag, torch.ones(()), torch.full((), rho))
        blocks = blocks * scale[:, None, None]
    inv_ps_r = 1.0 / ps[rows]
    blocks.diagonal(dim1=-2, dim2=-1).add_(
        diag.to(blocks.dtype)[:, None] * inv_ps_r)
    acc.add_(blocks)
    if sq is not None:
        sq.add_(blocks.mul_(blocks))


@pytest.mark.parametrize("sd", [False, True])
@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_plain_version_is_the_combine_before_the_kernel_bitwise(
        estimator, sd):
    """Two ranges of the packed-pair axis, the second holding the padded
    pairs: the plain version, and covariance_panels plus the adds, bitwise
    the arithmetic the port ran before the kernel."""
    o = _operands()
    eta = o["eta"] if estimator == "scaled" else None
    H = None if eta is None else cross_moments(eta)
    Q = o["rows"].shape[0]
    want_acc, want_sq = o["acc"].clone(), o["sq"].clone()
    got_acc, got_sq = o["acc"].clone(), o["sq"].clone()
    via_acc, via_sq = o["acc"].clone(), o["sq"].clone()
    for c0, c1 in sampler.pair_chunks(Q, 2):
        r, c = o["rows"][c0:c1], o["cols"][c0:c1]
        _before_the_kernel(want_acc[c0:c1], want_sq[c0:c1] if sd else None,
                           o["Lam"], o["ps"], RHO, r, c, eta)
        comb.combine_panels_plain(got_acc[c0:c1],
                                  got_sq[c0:c1] if sd else None, o["Lam"],
                                  o["ps"], r, c, RHO, H)
        blocks = covariance_panels(o["Lam"], o["ps"], RHO, r, c,
                                   eta_all=eta)
        via_acc[c0:c1].add_(blocks)
        if sd:
            via_sq[c0:c1].add_(blocks * blocks)
    assert (o["rows"][-2:] == 0).all() and (o["cols"][-2:] == 0).all()
    for got in (got_acc, via_acc):
        assert torch.equal(got, want_acc)
    for got in (got_sq, via_sq):
        assert torch.equal(got, want_sq if sd else o["sq"])


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("estimator", ["scaled", "plain"])
def test_add_panels_runs_the_wrapper_once_a_range(monkeypatch, estimator,
                                                  chunks):
    """A float32 combine is one wrapper call a range; the bf16 combine
    keeps covariance_panels' products and never calls it."""
    o = _operands()
    eta = o["eta"] if estimator == "scaled" else None
    state = tstate.SamplerState(Lambda=o["Lam"], Z=None, X=None, ps=o["ps"],
                                prior={})
    calls = []

    def counted(acc, sq, *args, **kw):
        calls.append(acc.shape[0])
        return comb.combine_panels(acc, sq, *args, **kw)

    monkeypatch.setattr(sampler, "combine_panels", counted)
    Q = o["rows"].shape[0]
    ranges = sampler.pair_chunks(Q, chunks)
    acc, sq = o["acc"].clone(), o["sq"].clone()
    sampler.add_panels(acc, sq, state, RHO, o["rows"], o["cols"], ranges,
                       eta=eta)
    assert calls == [c1 - c0 for c0, c1 in ranges]
    want = o["acc"].clone()
    comb.combine_panels(want, None, o["Lam"], o["ps"], o["rows"], o["cols"],
                        rho=RHO, H_grid=None if eta is None
                        else cross_moments(eta))
    assert torch.equal(acc, want)
    calls.clear()
    bf = o["acc"].clone()
    sampler.add_panels(bf, None, state, RHO, o["rows"], o["cols"], ranges,
                       eta=eta, compute_dtype=torch.bfloat16)
    assert calls == []
    ref = o["acc"] + covariance_panels(o["Lam"], o["ps"], RHO, o["rows"],
                                       o["cols"], eta_all=eta,
                                       compute_dtype=torch.bfloat16)
    assert torch.equal(bf, ref)


def _bad(o, what):
    """The wrapper's arguments with one of them made wrong."""
    args = dict(acc=o["acc"], sq=o["sq"], Lam_all=o["Lam"], ps_all=o["ps"],
                rows=o["rows"], cols=o["cols"],
                H_grid=cross_moments(o["eta"]))
    if what == "acc float64":
        args["acc"] = args["acc"].double()  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    elif what == "Lam float64":
        args["Lam_all"] = args["Lam_all"].double()  # dcfm-torch: ignore[DCFM301] - float64 on purpose: the wrapper's dtype refusal under test
    elif what == "H float16":
        args["H_grid"] = args["H_grid"].half()
    elif what == "rows int32":
        args["rows"] = args["rows"].int()
    elif what == "acc shape":
        args["acc"] = args["acc"][:, :, :-1]
    elif what == "sq shape":
        args["sq"] = args["sq"][1:]
    elif what == "ps shape":
        args["ps_all"] = args["ps_all"][:, :-1]
    elif what == "H shape":
        args["H_grid"] = args["H_grid"][:, :, :, :-1]
    elif what == "cols shape":
        args["cols"] = args["cols"][1:]
    elif what == "acc strided":
        args["acc"] = args["acc"].transpose(1, 2)
    elif what == "Lam strided":
        args["Lam_all"] = torch.empty(G, K, P).transpose(1, 2)
    elif what == "rows strided":
        args["rows"] = torch.stack([args["rows"]] * 2, 1)[:, 0]
    elif what == "sq strided":
        args["sq"] = args["sq"].transpose(1, 2)
    return args


@pytest.mark.parametrize("what,err", [
    ("acc float64", TypeError), ("Lam float64", TypeError),
    ("H float16", TypeError), ("rows int32", TypeError),
    ("acc shape", ValueError), ("sq shape", ValueError),
    ("ps shape", ValueError), ("H shape", ValueError),
    ("cols shape", ValueError), ("acc strided", ValueError),
    ("Lam strided", ValueError), ("rows strided", ValueError),
    ("sq strided", ValueError)])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, err):
    o = _operands()
    args = _bad(o, what)
    before = args["acc"].clone()
    with pytest.raises(err):
        comb.combine_panels(**args, rho=RHO)
    assert torch.equal(args["acc"], before)


def test_wrapper_reads_H_through_its_strides():
    """cross_moments returns a permuted view, which the wrapper takes as it
    is: the result equals the one from a contiguous copy."""
    o = _operands()
    H = cross_moments(o["eta"])
    assert not H.is_contiguous()
    a, b = o["acc"].clone(), o["acc"].clone()
    comb.combine_panels(a, None, o["Lam"], o["ps"], o["rows"], o["cols"],
                        rho=RHO, H_grid=H)
    comb.combine_panels(b, None, o["Lam"], o["ps"], o["rows"], o["cols"],
                        rho=RHO, H_grid=H.contiguous())
    assert torch.equal(a, b)


def test_the_launch_counter_has_the_combine_and_the_cpu_counts_nothing():
    """LAUNCHES names the combine kernel; the CPU's plain version (the
    wrapper on CPU tensors) launches nothing."""
    assert "combine_panels" in cuda_lib.launch_counts()
    before = cuda_lib.launch_counts()
    o = _operands()
    comb.combine_panels(o["acc"], o["sq"], o["Lam"], o["ps"], o["rows"],
                        o["cols"], rho=RHO)
    assert cuda_lib.launch_counts() == before
    assert cuda_lib.launch_counts()["combine_panels"] == 0
