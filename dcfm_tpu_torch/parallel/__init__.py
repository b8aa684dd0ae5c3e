"""The shard mesh: one fit over N rank processes (parallel/shard.py), laid
out by parallel/mesh.py; a pod of processes started from outside joins
one through parallel/multihost.py."""
