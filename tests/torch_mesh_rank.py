"""One rank of a gloo shard mesh, for tests/test_torch_mesh.py: one Gibbs
sweep of the port on the rank's block of shards, from a given state and the
recorded draws of the whole sweep (the JAX package's), and one saved
draw's packed panels on the rank's pair slice; rank 0 writes every rank's
results.  Run as

    python tests/torch_mesh_rank.py INPUT.pkl RANK WORLD STORE OUT.npz
"""

import math
import pickle
import sys

import numpy as np
import torch

from dcfm_tpu_torch.config import ModelConfig
from dcfm_tpu_torch.interop import state_from_numpy
from dcfm_tpu_torch.models.conditionals import covariance_panels, gibbs_sweep
from dcfm_tpu_torch.models.priors import make_prior
from dcfm_tpu_torch.noise import ShardSliceNoise
from dcfm_tpu_torch.parallel import shard
from dcfm_tpu_torch.parallel.mesh import make_layout


class Replay:
    """A provider whose sweep hands out recorded draws in call order,
    checking each call against its record."""

    def __init__(self, calls):
        self.calls = calls

    def sweep(self, chain, iteration):
        return _ReplayDraws(self.calls)


class _ReplayDraws:
    def __init__(self, calls):
        self.calls, self.i = calls, 0

    def _next(self, kind, site, shape, part):
        want = self.calls[self.i]
        self.i += 1
        if want[:4] != (kind, site, part, tuple(shape)):
            raise AssertionError(f"draw {self.i - 1}: {kind} {site} {part} "
                                 f"{tuple(shape)} vs recorded {want[:4]}")
        return torch.as_tensor(want[4])

    def normal(self, site, shape, *, part=None):
        return self._next("normal", site, shape, part)

    def exponential(self, site, shape, *, part=None):
        return self._next("exponential", site, shape, part)

    def uniform(self, site, shape, *, part=None):
        return self._next("uniform", site, shape, part)

    def standard_gamma(self, site, alpha, *, part=None):
        return self._next("standard_gamma", site, alpha.shape, part)

    def gamma_candidates(self, site, alphas, *, part=None):
        return self._next("gamma_candidates", site, alphas.shape, part)


def main(inp_path, rank, world, store, out_path):
    with open(inp_path, "rb") as f:
        inp = pickle.load(f)
    torch.set_num_threads(1)
    cpu = torch.device("cpu")
    cfg = ModelConfig(**inp["cfg"])
    G = cfg.num_shards
    shard._init_group(cpu, store, rank, world)
    mesh = shard.RankMesh(make_layout(world, rank, G, 1), cpu)
    lo, hi = mesh.shard_offset, mesh.shard_offset + mesh.layout.local_shards
    s0 = inp["state"]
    state = state_from_numpy(
        {"Lambda": s0["Lambda"][lo:hi], "Z": s0["Z"][lo:hi], "X": s0["X"],
         "ps": s0["ps"][lo:hi],
         "prior": {k: v[lo:hi] for k, v in s0["prior"].items()}}, cpu)
    draws = ShardSliceNoise(Replay(inp["calls"]), lo, hi - lo, G).sweep(0, 0)
    new, sse = gibbs_sweep(draws, torch.as_tensor(inp["Y"][lo:hi]), state,
                           cfg, make_prior(cfg), reduce_fn=mesh.reduce_fn)
    eta = (math.sqrt(cfg.rho) * new.X[None]
           + math.sqrt(1.0 - cfg.rho) * new.Z)
    panels = covariance_panels(
        mesh.gather_fn(new.Lambda), mesh.gather_fn(new.ps), cfg.rho,
        torch.as_tensor(mesh.pair_rows, dtype=torch.long),
        torch.as_tensor(mesh.pair_cols, dtype=torch.long),
        eta_all=mesh.gather_fn(eta))
    leaves = {"Lambda": new.Lambda, "Z": new.Z, "ps": new.ps, "sse": sse,
              "panels": panels, "X": new.X[None],
              **{k: v for k, v in new.prior.items()}}
    out = {k: mesh._every(v).numpy() for k, v in leaves.items()}
    if rank == 0:
        np.savez(out_path, **{k: (v if k == "X" else
                                  v.reshape(-1, *v.shape[2:]))
                              for k, v in out.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
