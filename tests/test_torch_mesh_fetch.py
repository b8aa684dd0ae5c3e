"""The shard mesh's post-hoc fetch (dcfm_tpu_torch/parallel/shard.py
``RankMesh.fetch``), on 4 gloo ranks of the CPU.

Each rank pools, scales and casts its own slice of the packed panels, and
rank 0 gathers the slices in pair order: the arithmetic is per panel, so
every ``fetch_dtype`` gives the bytes that a one-device fetch of the same
accumulators gives - here those of the mesh fit's final checkpoint,
pooled in chain order - on a packed (chains x shards) grid and with the
chains on every rank, the posterior SD beside the mean.  Under quant8 the
mesh streams its fetch ("auto"), and the final snapshot is the same
computation on the same sums (tests/test_torch_mesh_stream.py holds it
to the post-hoc fetch).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dcfm_tpu_torch as dt  # noqa: E402
from dcfm_tpu_torch.models.state import num_upper_pairs  # noqa: E402
from dcfm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from dcfm_tpu_torch.runtime import fetch  # noqa: E402
from dcfm_tpu_torch.utils import checkpoint as ck  # noqa: E402
from tests.conftest import make_synthetic  # noqa: E402

G, N, BURNIN, MCMC, THIN = 8, 50, 6, 8, 2


def _host(link, mode):
    """A link tensor as the fit's result holds it: int8 panels and scales
    under quant8, else widened to float32 (exactly)."""
    if mode == "quant8":
        return [t.numpy() for t in link]
    return [link.float().numpy()]


def _same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("C,mode,sd", [(2, "quant8", True),
                                       (2, "bfloat16", False),
                                       (3, "float16", True),
                                       (3, "float32", False)])
def test_the_mesh_fetch_is_the_one_device_fetch_of_its_accumulators(
        tmp_path, C, mode, sd):
    Y, _ = make_synthetic(N, 96, 3, seed=4)
    path = str(tmp_path / "f.npz")
    cfg = dt.FitConfig(
        model=dt.ModelConfig(num_shards=G, factors_per_shard=3, rho=0.8,
                             posterior_sd=sd),
        run=dt.RunConfig(burnin=BURNIN, mcmc=MCMC, thin=THIN, seed=2,
                         num_chains=C, chunk_size=7),
        backend=dt.BackendConfig(backend="torch_cpu", mesh_devices=4,
                                 fetch_dtype=mode, sse_mode="gram"),
        checkpoint_path=path, checkpoint_every_chunks=1)
    res = dt.fit(Y, cfg)
    # C = 2 packs one chain a row of 2 ranks; 3 chains run on every rank
    assert tmesh.make_layout(4, 0, G, C).rows == (2 if C == 2 else 1)
    tpl = ck.carry_template(cfg.model, n=N, P=res.preprocess.data.shape[2],
                            num_chains=C)
    leaves, meta = ck.load_checkpoint(path, tpl)
    assert meta["iteration"] == BURNIN + MCMC

    def pooled(name):
        acc = torch.from_numpy(leaves[name])
        out = acc[0].clone()
        for c in range(1, C):
            out += acc[c]
        return out

    _, inv, bessel = fetch.accumulator_window(BURNIN + MCMC, BURNIN, THIN,
                                              0, C)
    acc = pooled("sigma_acc")
    want = _host(fetch.fetch_prep(acc, C, G, inv, mode), mode)
    _same([res._q8_panels, res._q8_scales] if mode == "quant8"
          else [res._upper_f32], want)
    if not sd:
        assert res._sd_upper_f32 is None and res._sd_q8_panels is None
        return
    want = _host(fetch.fetch_sd_prep(pooled("sigma_sq_acc"),
                                     acc[:num_upper_pairs(G)], C, inv,
                                     bessel, mode), mode)
    _same([res._sd_q8_panels, res._sd_q8_scales] if mode == "quant8"
          else [res._sd_upper_f32], want)
