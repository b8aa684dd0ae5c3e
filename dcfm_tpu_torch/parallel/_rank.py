"""Entry of a started shard-mesh rank: ``python -m
dcfm_tpu_torch.parallel._rank ARGS`` (parallel/shard.start_mesh)."""

import sys

from dcfm_tpu_torch.parallel.shard import rank_main

if __name__ == "__main__":
    rank_main(sys.argv[1])
