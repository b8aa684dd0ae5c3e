"""The rank layout of the shard mesh, with no process group in it.

The port of the layout half of ``dcfm_tpu/parallel/mesh.py``.  A mesh fit
runs N rank processes (parallel/shard.py); this module says which shards,
which chains and which packed panels each rank owns.  The divide-and-
conquer shard axis splits over the ranks as contiguous blocks: rank r of a
row owns shards ``[r * Gl, (r + 1) * Gl)`` and the packed-pair slice
``[r * q_local, (r + 1) * q_local)`` of the canonical triu-order map
(``models/state.packed_pair_indices``), whose padded length is a multiple
of g, so it splits evenly over any legal mesh.

With C > 1 chains the ranks form a (chains x shards) grid when
:func:`legal_chain_grid` holds (the JAX package's ``make_chain_mesh``):
chain rows are the major axis, row c a contiguous block of N / C ranks
running chain c over all g shards, and no sweep collective crosses a row.
Otherwise every rank runs all C chains on its shards (the JAX package's
vmapped chain axis).  Chains keep their GLOBAL index either way, so a
chain draws the same stream wherever it runs.

A pod (parallel/multihost.py: N processes that met through the
``DCFM_*`` environment) lays its ranks out as the JAX package's pod mesh,
(chains x) hosts x shards (:func:`make_pod_layout`): each process is one
host row of one device, so the chains pack only when
:func:`legal_pod_grid` holds for N hosts over N devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dcfm_tpu_torch.models.state import num_padded_pairs, packed_pair_indices


def shards_per_device(num_shards: int, num_devices: int) -> int:
    """Shards per rank of a row of ``num_devices`` ranks (the JAX
    package's check and message)."""
    d = num_devices
    if num_shards % d != 0:
        raise ValueError(
            f"g={num_shards} shards must divide over {d} mesh devices; "
            "choose g as a multiple of the mesh size")
    return num_shards // d


def legal_chain_grid(num_chains: int, num_devices: int,
                     num_shards: int) -> bool:
    """True when a packed (chains x shards) grid is legal for this C x N
    topology: C > 1 chain rows dividing the N ranks evenly, with the g
    shards dividing each row's N / C ranks (``dcfm_tpu/parallel/mesh.py``'s
    predicate for one process)."""
    return (num_chains > 1 and num_devices % num_chains == 0
            and num_shards % (num_devices // num_chains) == 0)


def legal_pod_grid(num_chains: int, num_hosts: int, num_devices: int,
                   num_shards: int) -> bool:
    """True when the host-sharded pod grid is legal for this C x H x N
    topology: H > 1 host rows, (H * C) dividing the N devices evenly, and
    the g shards dividing each chain's block of N / C devices (the JAX
    package's ``legal_pod_grid``)."""
    if num_hosts < 2 or num_chains < 1:
        return False
    if num_devices % (num_hosts * max(num_chains, 1)) != 0:
        return False
    per_chain = num_devices // max(num_chains, 1)
    return num_shards % per_chain == 0


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """Rank ``rank`` of a ``world``-rank mesh over ``num_shards`` shards
    and ``num_chains`` chains, packed into ``rows`` chain rows (1: every
    rank runs every chain)."""

    world: int
    rank: int
    num_shards: int
    num_chains: int
    rows: int = 1       # the chain axis' size (the JAX ``chain_rows``)

    @property
    def cols(self) -> int:
        """Ranks per chain row: the shard axis' size."""
        return self.world // self.rows

    @property
    def row(self) -> int:
        return self.rank // self.cols

    @property
    def col(self) -> int:
        return self.rank % self.cols

    @property
    def local_shards(self) -> int:
        return shards_per_device(self.num_shards, self.cols)

    @property
    def shard_offset(self) -> int:
        return self.col * self.local_shards

    @property
    def chains(self) -> range:
        """The global indices of this rank's chains."""
        c_loc = self.num_chains // self.rows
        return range(self.row * c_loc, (self.row + 1) * c_loc)

    @property
    def local_pairs(self) -> int:
        return num_padded_pairs(self.num_shards) // self.cols

    @property
    def pair_offset(self) -> int:
        return self.col * self.local_pairs

    def row_ranks(self, row: int) -> list:
        """The ranks of chain row ``row``, in shard order."""
        return list(range(row * self.cols, (row + 1) * self.cols))


def make_layout(world: int, rank: int, num_shards: int,
                num_chains: int) -> RankLayout:
    """Rank ``rank``'s layout: the chains packed one per row when
    :func:`legal_chain_grid` holds, else all of them on every rank; the
    shard count's divisibility is checked here."""
    rows = (num_chains if legal_chain_grid(num_chains, world, num_shards)
            else 1)
    shards_per_device(num_shards, world // rows)
    return RankLayout(world=world, rank=rank, num_shards=num_shards,
                      num_chains=num_chains, rows=rows)


def make_pod_layout(world: int, rank: int, num_shards: int,
                    num_chains: int) -> RankLayout:
    """Rank ``rank``'s layout in a pod of ``world`` processes, one device
    each: the JAX package's ``make_pod_mesh`` over ``world`` host rows -
    the chains packed one per row when :func:`legal_pod_grid` holds for
    ``world`` hosts over ``world`` devices (only one chain does: a row of
    one device cannot hold more), else every rank runs every chain on its
    block of shards (the vmapped chain axis).  The shard count's
    divisibility is checked here."""
    rows = (num_chains if num_chains > 1 and legal_pod_grid(
        num_chains, world, world, num_shards) else 1)
    shards_per_device(num_shards, world // rows)
    return RankLayout(world=world, rank=rank, num_shards=num_shards,
                      num_chains=num_chains, rows=rows)


def pair_slice(layout: RankLayout) -> tuple[np.ndarray, np.ndarray]:
    """This rank's contiguous slice of the packed-pair index map:
    ``(rows, cols)``, each ``(local_pairs,)``."""
    r, c = packed_pair_indices(layout.num_shards)
    lo = layout.pair_offset
    hi = lo + layout.local_pairs
    return r[lo:hi], c[lo:hi]
