"""The pod: N processes of one fit, meeting through the environment.

The port of ``dcfm_tpu/parallel/multihost.py``.  Where the shard mesh
(parallel/shard.start_mesh) is started by its caller, a pod's processes
are started from outside - by a cluster launcher, by hand, or by
``dcfm-tpu-torch supervise --pod N`` - and each runs the same ``fit``
call.  They meet over ``torch.distributed``: :func:`initialize` joins
the process group through a TCP store at the coordinator's address
(process 0 serves it), over NCCL on card ``process_id % device_count``
when the process runs on a card and over gloo on the CPU, and
:func:`initialize_from_env` reads the JAX package's contract,
``DCFM_COORDINATOR`` / ``DCFM_NUM_PROCESSES`` / ``DCFM_PROCESS_ID``
(a no-op when they are unset, so a one-process run needs nothing).

Once joined, ``api.fit`` runs as one rank of the pod: the ranks are laid
out as the JAX package's pod mesh (parallel/mesh.make_pod_layout), each
rank saves its own ``path.procK-of-N`` file (utils/checkpoint.
save_checkpoint_multiprocess), the resume is collective
(runtime/resume.resume_state_multiproc), the post-hoc fetch is
replicated so every process returns the same result, and a
``stream_artifact`` is written cooperatively (serve/artifact.
write_artifact_cooperative).  A pod of one process is a one-process fit,
as in the JAX package.  Every process must pass the same ``Y``: fit's
preprocessing is seeded, so each derives the same shards and keeps its
block.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import Optional

import torch
import torch.distributed as dist

from dcfm_tpu_torch.parallel import shard
from dcfm_tpu_torch.parallel.mesh import make_pod_layout

# The environment rendezvous contract (initialize_from_env).  The pod
# supervisor (resilience/supervisor.run_supervised_cli with pod=N,
# `dcfm-tpu-torch supervise --pod N`) exports exactly these per child
# process - with a FRESH coordinator port per relaunch attempt, so a
# restarted pod never races the dead coordinator's socket.
COORDINATOR_ENV = "DCFM_COORDINATOR"
NUM_PROCESSES_ENV = "DCFM_NUM_PROCESSES"
PROCESS_ID_ENV = "DCFM_PROCESS_ID"


@dataclasses.dataclass(frozen=True)
class Pod:
    """This process's place in the pod it joined."""

    num_processes: int
    process_id: int
    device: torch.device
    backend: str                 # "nccl" or "gloo"
    rendezvous_s: float          # seconds :func:`initialize` waited


_POD: Optional[Pod] = None


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, *, device=None) -> Pod:
    """Join the pod: process ``process_id`` of ``num_processes`` meets
    the others through a TCP store at ``coordinator_address``
    (``host:port``; process 0 serves it) and the ``torch.distributed``
    process group is initialized - NCCL on card ``process_id %
    torch.cuda.device_count()`` when ``device`` is a card (None: the card
    when there is one), else gloo.  Joining the same pod again is a
    no-op; any other second join raises."""
    global _POD
    if _POD is not None:
        if (_POD.num_processes, _POD.process_id) == (num_processes,
                                                     process_id):
            return _POD
        raise RuntimeError(
            f"this process already joined a pod as process "
            f"{_POD.process_id} of {_POD.num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} not in "
                         f"[0, {num_processes})")
    if dist.is_initialized():
        raise RuntimeError(
            "a pod needs its own torch.distributed process group, but "
            "this process already has one")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    host, port = coordinator_address.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=shard.TIMEOUT_S)
    kw, backend = {}, "gloo"
    if device.type == "cuda":
        device = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
        backend, kw["device_id"] = "nccl", device
    t = time.perf_counter()
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout, **kw)
    _POD = Pod(num_processes=num_processes, process_id=process_id,
               device=device, backend=backend,
               rendezvous_s=time.perf_counter() - t)
    return _POD


def initialize_from_env(*, device=None) -> Optional[int]:
    """:func:`initialize` from ``DCFM_COORDINATOR`` /
    ``DCFM_NUM_PROCESSES`` / ``DCFM_PROCESS_ID``; returns the process id,
    or None (no-op) when the variables are unset."""
    coord = os.environ.get(COORDINATOR_ENV)
    if not coord:
        return None
    num = int(os.environ[NUM_PROCESSES_ENV])
    pid = int(os.environ[PROCESS_ID_ENV])
    initialize(coord, num, pid, device=device)
    return pid


def pod() -> Optional[Pod]:
    """The pod this process joined, or None."""
    return _POD


def process_count() -> int:
    """The pod's processes (1 outside a pod): the JAX package's
    ``jax.process_count()``."""
    return 1 if _POD is None else _POD.num_processes


def process_index() -> int:
    """This process's index in the pod (0 outside a pod)."""
    return 0 if _POD is None else _POD.process_id


def barrier(tag: str = "") -> None:
    """Every process of the pod reaches here before any leaves (the JAX
    package's ``sync_global_devices(tag)``; a no-op outside a pod)."""
    if process_count() > 1:
        dist.barrier()


def pod_mesh(num_shards: int, num_chains: int) -> shard.RankMesh:
    """This process's rank of a fit over the whole pod: the pod layout
    (parallel/mesh.make_pod_layout) on the pod's device, with no ranks of
    its own to start or reap."""
    if _POD is None:
        raise RuntimeError("not in a pod: call initialize() first")
    layout = make_pod_layout(_POD.num_processes, _POD.process_id,
                             num_shards, num_chains)
    return shard.RankMesh(layout, _POD.device, pod=True)


def shutdown() -> None:
    """Leave the pod (its process group is destroyed)."""
    global _POD
    if _POD is not None and dist.is_initialized():
        dist.destroy_process_group()
    _POD = None
