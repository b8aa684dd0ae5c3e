"""Checkpoint files of the chains: format, integrity, retention, the
write-behind writer and the snapshot of a chain on the card.

The port of the single-process part of ``dcfm_tpu/utils/checkpoint.py``.
The restartable state of a fit is its chains' carries (sampler state,
packed covariance accumulator, iteration, health), the FitConfig (to
refuse resuming under a different model) and a fingerprint of the sharded
data (preprocessing is deterministic given the seed, so the resumed fit
recomputes it from the caller's Y and the fingerprint refuses other data).

Format: the JAX package's v8 - one ``.npz`` with the leaves ``leaf_0``,
``leaf_1``, ... in the JAX ``ChainCarry``'s flatten order
(:func:`file_leaves`: Lambda, Z, X, ps, the prior's leaves by name - MGP
delta and psijh, horseshoe lam2, nu, tau2 and xi, DL phi, psi and tau -,
the column mask ``active`` under rank adaptation, sigma_acc, iteration,
health, and where present sigma_sq_acc (``ModelConfig.posterior_sd``), the
draw ring's Lambda, ps, X and H (``RunConfig.store_draws``; no H under the
plain estimator) and y_imp_acc (missing-data imputation); a light file
drops the accumulators - sigma_acc, sigma_sq_acc, y_imp_acc, never the
ring - and renumbers), a leading chain axis on every leaf
when there is more than one chain and none for one, and a JSON
``__meta__`` entry with the JAX package's keys, per-leaf CRC32s among
them.  The config in it is the port's FitConfig, whose fields are the
JAX package's, in its nesting and key order (a port file names its own
``backend``, e.g. "torch_cuda", which the JAX package's reader reads as
it reads any string).  So the JAX package's ``verify_checkpoint``,
``config_from_checkpoint_meta`` and ``load_checkpoint`` (with a
``jax.eval_shape`` template) read a port file leaf for leaf.

One key is the port's own: ``"rng": "torch-philox"``, naming the random
streams the chains were drawn from (``noise.TorchNoise``).  The port
continues only files that carry it: a chain the JAX package wrote came
from threefry keys and cannot be continued on Philox streams as the same
chain.  The JAX package never reads the key: its own gates accept a
compatible port file and continue the chain on threefry keys - a valid
chain, bitwise equal to no run of either package.  Reading the sums
needs no stream: :func:`dcfm_tpu_torch.serve.artifact.export_from_checkpoint`
exports a file of either package.

Elastic adoption (:func:`load_checkpoint_elastic`) reads a full file
written at another chain count: a shrink folds the dropped chains'
accumulators into chain 0, a grow splices in re-lineaged births; the meta
v7 fields (``chain_acc_starts``, ``fold_draws``, ``elastic_lineage``)
keep the divisor exact.

Writes are atomic (tmp + rename), so a crash mid-save never corrupts the
previous checkpoint; ``keep_last`` > 1 keeps older generations as
``.bakK`` files.  Every durable write is a ``checkpoint_save``
flight-recorder event (obs/recorder.py), emitted from the writer's thread
after the rename: a file write, no card call.  The fault-injection seam of
the JAX writer (``fault_plan``) comes with the fit's other fault seams
(ROADMAP Queue A item 7); until then ``api.fit`` refuses a plan that
targets it.  :func:`strip_checkpoint` rewrites a full file as a light one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import tempfile
import threading
import time
import zipfile
import zlib
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dcfm_tpu_torch.config import (
    AdaptConfig, BackendConfig, DLConfig, FitConfig, HorseshoeConfig,
    MGPConfig, ModelConfig, RunConfig, WarmStart)
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.models.state import num_padded_pairs
from dcfm_tpu_torch.obs.recorder import record

# the random streams a port chain is drawn from (meta["rng"])
RNG_STREAMS = "torch-philox"

# the JAX package's format version, and the versions whose meta it reads
_FORMAT_VERSION = 8
_LOADABLE_VERSIONS = (_FORMAT_VERSION, 7, 6)

# the leaves of a chain's carry in the JAX ChainCarry's flatten order: the
# SamplerState's (Lambda, Z, X, ps, the prior's leaves by name, the column
# mask under rank adaptation), then sigma_acc, iteration, health, and
# where present sigma_sq_acc, the draw ring and y_imp_acc (they follow
# health in the JAX ChainCarry, in that order).  The constants are the
# default model's (MGP, no adaptation, no ring, complete data)
PRIOR_LEAVES = {"mgp": ("delta", "psijh"),
                "horseshoe": ("lam2", "nu", "tau2", "xi"),
                "dl": ("phi", "psi", "tau")}
STATE_LEAVES = ("Lambda", "Z", "X", "ps") + PRIOR_LEAVES["mgp"]
FULL_LEAVES = STATE_LEAVES + ("sigma_acc", "iteration", "health")
FULL_LEAVES_SD = FULL_LEAVES + ("sigma_sq_acc",)
# a light (state-only) file drops the accumulators: the JAX _slim carry
LIGHT_LEAVES = STATE_LEAVES + ("iteration", "health")
# the accumulators a light file drops and a light resume restarts at zero
ACC_LEAVES = ("sigma_acc", "sigma_sq_acc", "y_imp_acc")
# the draw ring's leaves, the JAX DrawBuffers' fields in order
DRAW_LEAVES = ("draws_Lambda", "draws_ps", "draws_X", "draws_H")


def state_leaf_names(model: ModelConfig) -> tuple:
    """The sampler state's leaves under ``model``, in flatten order."""
    return (("Lambda", "Z", "X", "ps") + PRIOR_LEAVES[model.prior]
            + (("active",) if model.rank_adapt else ()))


def file_leaves(model: ModelConfig, state_only: bool,
                posterior_sd: bool, *, draws: bool = False,
                impute: bool = False) -> tuple:
    """The leaf names of a file, in leaf order: ``draws`` with the draw
    ring (its H under the scaled estimator), ``impute`` with the
    imputation sum."""
    state = state_leaf_names(model)
    ring = (tuple(k for k in DRAW_LEAVES
                  if k != "draws_H" or model.estimator == "scaled")
            if draws else ())
    if state_only:
        return state + ("iteration", "health") + ring
    return (state + ("sigma_acc", "iteration", "health")
            + (("sigma_sq_acc",) if posterior_sd else ()) + ring
            + (("y_imp_acc",) if impute else ()))


def _treedef(model: ModelConfig, names: tuple) -> str:
    prior = ", ".join(PRIOR_LEAVES[model.prior])
    active = ", active" if model.rank_adapt else ""
    ring = [k[len("draws_"):] for k in names if k in DRAW_LEAVES]
    tail = [k for k in names if k in ("sigma_acc", "iteration", "health",
                                      "sigma_sq_acc")]
    tail += [f"draws=DrawBuffers({', '.join(ring)})"] if ring else []
    tail += ["y_imp_acc"] if "y_imp_acc" in names else []
    return (f"ChainCarry(state=SamplerState(Lambda, Z, X, ps, prior={{"
            f"{prior}}}{active}), {', '.join(tail)})")


class CheckpointCorruptError(ValueError):
    """A checkpoint leaf failed its recorded CRC32: the file's bytes are
    not the bytes that were written (a torn write the rename hid, a media
    error).  ``path`` names the offending file."""

    def __init__(self, message: str, *, path: str = ""):
        super().__init__(message)
        self.path = path


def carry_template(model: ModelConfig, *, n: int, P: int,
                   num_chains: int, num_stored_draws: int = 0) -> dict:
    """``{leaf: (shape, numpy dtype)}`` of a fit's checkpoint, full form,
    with the chain-axis convention (a leading ``num_chains`` axis when
    there is more than one chain).  ``model`` is the fit's internal model
    (its ``impute_missing`` set when the data has NaN: the file then holds
    y_imp_acc); ``num_stored_draws`` sizes the draw ring (0: none)."""
    G, K, S = model.num_shards, model.factors_per_shard, num_stored_draws
    shapes = {"Lambda": (G, P, K), "Z": (G, n, K), "X": (n, K),
              "ps": (G, P), "delta": (G, K), "psijh": (G, P, K),
              "lam2": (G, P, K), "nu": (G, P, K), "tau2": (G,), "xi": (G,),
              "phi": (G, P, K), "psi": (G, P, K), "tau": (G, P),
              "active": (G, K), "sigma_acc": (num_padded_pairs(G), P, P),
              "sigma_sq_acc": (num_padded_pairs(G), P, P), "iteration": (),
              "health": (G, 4), "draws_Lambda": (S, G, P, K),
              "draws_ps": (S, G, P), "draws_X": (S, n, K),
              "draws_H": (S, G, G, K, K), "y_imp_acc": (G, n, P)}
    core = {k: shapes[k] for k in file_leaves(
        model, False, model.posterior_sd, draws=bool(S),
        impute=model.impute_missing)}
    lead = (num_chains,) if num_chains > 1 else ()
    return {k: (lead + s, np.dtype(np.int32 if k == "iteration"
                                   else np.float32))
            for k, s in core.items()}


def _chain_tensors(carry, state_only: bool) -> dict:
    """One chain's leaves as tensors (iteration stays a Python int); a
    light snapshot keeps the draw ring, as the JAX package's does."""
    st = carry.state
    out = {"Lambda": st.Lambda, "Z": st.Z, "X": st.X, "ps": st.ps,
           **st.prior}
    if st.active is not None:
        out["active"] = st.active
    if not state_only:
        out["sigma_acc"] = carry.sigma_acc
        if carry.sigma_sq_acc is not None:
            out["sigma_sq_acc"] = carry.sigma_sq_acc
        if carry.y_imp_acc is not None:
            out["y_imp_acc"] = carry.y_imp_acc
    if carry.draws is not None:
        out.update((k, t) for k, t in zip(DRAW_LEAVES, carry.draws)
                   if t is not None)
    out["health"] = carry.health
    return out


_STREAMS: dict = {}     # device index -> the snapshots' side stream


def _snapshot_stream(device: torch.device):
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class Snapshot:
    """The chains' carries copied to the host, as checkpoint leaves.

    On the card the copies go into pinned host memory on a side stream
    that first waits for the work queued so far on the current stream;
    one event marks their end, and it is appended to every carry's
    ``readers``, so the runner waits for it before it writes a carry
    again (models/sampler.wait_readers).  :meth:`wait` (the writer's
    thread) waits for that event before anything reads the host copies;
    the device tensors are kept alive until then.  On the CPU the leaves
    are copied at once."""

    def __init__(self, carries: list, *, state_only: bool):
        C = len(carries)
        iters = np.asarray([int(c.iteration) for c in carries], np.int32)
        self._iteration = iters if C > 1 else iters[0].copy()
        per_chain = [_chain_tensors(c, state_only) for c in carries]
        self._event, self._src = None, None
        first = per_chain[0]["Lambda"]
        if first.device.type != "cuda":
            self._host = {k: (np.stack([t[k].numpy() for t in per_chain])
                              if C > 1 else per_chain[0][k].numpy().copy())
                          for k in per_chain[0]}
            return
        side = _snapshot_stream(first.device)
        side.wait_stream(torch.cuda.current_stream(first.device))
        self._host = {}
        with torch.cuda.stream(side):
            for k, t0 in per_chain[0].items():
                host = torch.empty(((C,) if C > 1 else ()) + tuple(t0.shape),
                                   dtype=t0.dtype, pin_memory=True)
                for c, t in enumerate(per_chain):
                    (host[c] if C > 1 else host).copy_(t[k],
                                                       non_blocking=True)
                self._host[k] = host
            self._event = torch.cuda.Event()
            self._event.record(side)
        self._src = per_chain
        for c in carries:
            c.readers.append(self._event)

    def wait(self) -> dict:
        """``{leaf name: numpy array}`` once the copies have landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event, self._src = None, None
        out = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
               for k, v in self._host.items()}
        out["iteration"] = self._iteration
        return out


def _num_chains(leaves: dict) -> int:
    it = np.asarray(leaves["iteration"])
    return int(it.shape[0]) if it.ndim else 1


def data_fingerprint(data) -> str:
    """Cheap content hash of the sharded (g, n, P) data: its shape and a
    strided sample (the JAX package's).

    Accepts the dense array or a lazy shard source
    (utils.preprocess.LazyShardData): the lazy walk samples the same
    C-order flat indices block of shards by block of shards, so both forms
    of the same data hash identically and a sparse-ingested refit can
    resume a dense checkpoint (and vice versa)."""
    h = hashlib.sha256()
    h.update(str(tuple(data.shape)).encode())
    if isinstance(data, np.ndarray):
        flat = np.ascontiguousarray(data).reshape(-1)
        h.update(flat[:: max(1, flat.size // 65536)].tobytes())
        return h.hexdigest()[:16]
    g, n, P = data.shape
    size = g * n * P
    idx = np.arange(0, size, max(1, size // 65536), dtype=np.int64)
    step = data.shards_per_chunk
    for lo in range(0, g, step):
        hi = min(lo + step, g)
        a, b = lo * n * P, hi * n * P
        sel = idx[(idx >= a) & (idx < b)]
        if sel.size:
            # hashing is sequential: per-block updates hash the same
            # bytes as the dense branch's one update
            h.update(data.chunk(lo, hi).reshape(-1)[sel - a].tobytes())
    return h.hexdigest()[:16]


def _config_to_json(cfg: FitConfig) -> dict:
    """The config as the JAX package's ``_config_to_json`` writes it: the
    port's dataclasses have the JAX package's fields in its order, so
    ``asdict`` is every key in its place."""
    return dataclasses.asdict(cfg)


def _fields(cls, d: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def _config_from_json(d: dict) -> FitConfig:
    """The port's FitConfig from a config JSON of either package, of any
    version: a key the port has no field for is dropped, a field the file
    lacks (older port files had no ``backend``, ``profile_dir`` or
    ``obs``) takes its default.  No value is checked here: a JAX file's
    ``backend="jax_tpu"`` reads as it is (export, warm starts), and only
    ``fit`` refuses it."""
    model = _fields(ModelConfig, d["model"])
    for key, cls in (("mgp", MGPConfig), ("horseshoe", HorseshoeConfig),
                     ("dl", DLConfig), ("adapt", AdaptConfig)):
        if key in model:
            model[key] = cls(**model[key])
    rest = {k: v for k, v in _fields(FitConfig, d).items()
            if k not in ("model", "run", "backend")}
    if rest.get("warm_start"):
        rest["warm_start"] = WarmStart(**rest["warm_start"])
    return FitConfig(model=ModelConfig(**model),
                     run=RunConfig(**_fields(RunConfig, d["run"])),
                     backend=BackendConfig(**_fields(BackendConfig,
                                                     d["backend"])),
                     **rest)


def config_from_checkpoint_meta(meta: dict) -> FitConfig:
    """The FitConfig a checkpoint of either package was written under."""
    return _config_from_json(meta["config"])


def elastic_meta(meta: dict, num_chains: int) -> Tuple[list, int, int]:
    """``(chain_acc_starts, fold_draws, elastic_lineage)`` of a loadable
    meta, with the lossless v6 defaults (uniform starts at ``acc_start``,
    nothing folded, lineage 0) where the file predates the v7 fields.
    ``num_chains`` is the chain count the file was written at."""
    acc_start = int(meta.get("acc_start", 0))
    starts = meta.get("chain_acc_starts")
    if starts is None:
        starts = [acc_start] * int(num_chains)
    return ([int(a) for a in starts], int(meta.get("fold_draws", 0)),
            int(meta.get("elastic_lineage", 0)))


def _leaf_crc(arr: np.ndarray) -> int:
    """CRC32 of a leaf's raw bytes."""
    a = np.ascontiguousarray(arr)
    return zlib.crc32(a.reshape(-1).view(np.uint8))


def _read_leaf(z, meta: dict, name: str, path: str) -> np.ndarray:
    """One payload entry, checked against its recorded CRC32.  A byte
    that changed on disk fails the zip member's own CRC first: that is
    the same corruption, and raises the same error."""
    try:
        arr = z[name]
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(f"{path}: checkpoint entry {name!r} "
                                     f"is unreadable ({e})", path=path) from e
    _verify_crc(meta, name, arr, path)
    return arr


def _verify_crc(meta: dict, name: str, arr: np.ndarray, path: str) -> None:
    """Check one loaded payload entry against the CRC recorded at save
    (files written before the integrity format carry none: unverified)."""
    want = (meta.get("leaf_crc") or {}).get(name)
    if want is None:
        return
    got = _leaf_crc(arr)
    if got != int(want):
        raise CheckpointCorruptError(
            f"{path}: checkpoint entry {name!r} fails its CRC32 (stored "
            f"{int(want):#010x}, computed {got:#010x}) - the file is "
            "corrupt (torn write, media error); resuming it would compute "
            "on garbage", path=path)


def retained_path(path: str, k: int) -> str:
    """Name of the k-th retained (rotated-out) checkpoint, k >= 1."""
    return f"{path}.bak{k}"


def retained_checkpoints(path: str) -> list:
    """The live file (if present) and every ``.bakK`` the keep_last
    rotation produced, newest first; holes in the K sequence are
    tolerated (a directory listing, not sequential probing)."""
    out = [path] if os.path.exists(path) else []
    d = os.path.dirname(os.path.abspath(path)) or "."
    if os.path.isdir(d):
        pat = re.compile(re.escape(os.path.basename(path)) + r"\.bak(\d+)$")
        ks = sorted(int(m.group(1)) for f in os.listdir(d)
                    for m in [pat.match(f)] if m)
        out.extend(retained_path(path, k) for k in ks)
    return out


def _rotate_retained(target: str, keep_last: int) -> None:
    """Shift the retention chain before a new save lands on ``target``:
    bak(K-1) -> bakK, ..., then a hard link target -> bak1 (so there is
    no instant with no file at ``target``).  keep_last=1 retains
    nothing."""
    if keep_last <= 1 or not os.path.exists(target):
        return
    for k in range(keep_last - 1, 1, -1):
        src = retained_path(target, k - 1)
        if os.path.exists(src):
            os.replace(src, retained_path(target, k))
    b1 = retained_path(target, 1)
    if os.path.exists(b1):
        os.unlink(b1)
    try:
        os.link(target, b1)
    except OSError:
        # filesystems without hard links: a real copy
        shutil.copy2(target, b1)


def _atomic_savez(target: str, meta: dict, payload: dict, *,
                  keep_last: int = 1) -> None:
    """Atomic npz write (tmp + rename) with every payload entry's CRC32 in
    ``meta["leaf_crc"]`` and the ``keep_last`` rotation first; one
    ``checkpoint_save`` event per durable write."""
    t0 = time.perf_counter()
    d = os.path.dirname(os.path.abspath(target)) or "."
    os.makedirs(d, exist_ok=True)
    meta = dict(meta)
    meta["leaf_crc"] = {k: _leaf_crc(np.asarray(v))
                        for k, v in payload.items()}
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                               dtype=np.uint8), **payload)
        _rotate_retained(target, keep_last)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    record("checkpoint_save", path=os.path.basename(target),
           target="checkpoint", iteration=meta.get("iteration", -1),
           state_only=bool(meta.get("state_only")),
           acc_start=meta.get("acc_start", 0),
           dur_s=time.perf_counter() - t0)


def save_checkpoint(path: str, leaves: dict, cfg: FitConfig, *,
                    fingerprint: str, state_only: bool = False,
                    acc_start: int = 0, keep_last: int = 1,
                    chain_acc_starts=None, fold_draws: int = 0,
                    elastic_lineage: int = 0) -> None:
    """Atomically write the chains' leaves (``{name: numpy array}``, a
    :class:`Snapshot`'s), the config and the data fingerprint, with the
    JAX package's v8 meta and the port's stream key.

    ``state_only`` writes the light file (no accumulators: MBs instead of
    the p^2-sized full file); a light resume restarts accumulation at the
    saved iteration.  ``acc_start`` is the global iteration the current
    accumulators' window started at (0 for an uninterrupted run), so a
    full save after a light resume stays self-describing;
    ``chain_acc_starts`` / ``fold_draws`` / ``elastic_lineage`` the v7
    bookkeeping of an elastic adoption (None: uniform starts at
    ``acc_start``)."""
    names = file_leaves(cfg.model, state_only, "sigma_sq_acc" in leaves,
                        draws="draws_Lambda" in leaves,
                        impute="y_imp_acc" in leaves)
    num_chains = int(cfg.run.num_chains)
    if _num_chains(leaves) != num_chains:
        raise ValueError(f"{_num_chains(leaves)} chains' leaves for a "
                         f"config of {num_chains} chains")
    topology = {"num_chains": num_chains, "num_devices": 1,
                "num_processes": 1}
    meta = {
        "version": _FORMAT_VERSION,
        "config": _config_to_json(cfg),
        "treedef": _treedef(cfg.model, names),
        "iteration": int(np.asarray(leaves["iteration"]).reshape(-1)[0]),
        "fingerprint": fingerprint,
        "state_only": bool(state_only),
        "acc_start": int(acc_start),
        "acc_leaf_indices": [i for i, k in enumerate(names)
                             if k in ACC_LEAVES],
        "chain_acc_starts": [int(a) for a in (
            chain_acc_starts if chain_acc_starts is not None
            else [acc_start] * num_chains)],
        "fold_draws": int(fold_draws),
        "elastic_lineage": int(elastic_lineage),
        "pod_hosts": 1,
        "pod_adoptions": 0,
        "topology": topology,
        "rng": RNG_STREAMS,
    }
    _atomic_savez(path, meta, {f"leaf_{i}": np.asarray(leaves[k])
                               for i, k in enumerate(names)},
                  keep_last=keep_last)


def strip_checkpoint(src: str, dst: str) -> None:
    """Rewrite a FULL checkpoint as a state-only (light) one: drop the
    accumulator leaves its meta records (renumbering the kept leaves into
    the light file's order), turning a p^2-sized snapshot into MBs.  The
    result resumes like any light checkpoint: the chain state exact,
    accumulation restarted at the saved iteration.  Every kept leaf is
    CRC-checked on the way through; the port's stream key is kept."""
    with _open(src) as z:
        meta = _read_meta(z, src)
        if meta.get("state_only"):
            raise ValueError("checkpoint is already state-only")
        drop = set(meta.get("acc_leaf_indices", []))
        if not drop:
            raise ValueError(
                "checkpoint records no accumulator leaves to strip "
                "(written by an older version?)")
        n_full = sum(1 for k in z.files if k != "__meta__")
        kept = [i for i in range(n_full) if i not in drop]
        payload = {f"leaf_{j}": _read_leaf(z, meta, f"leaf_{i}", src)
                   for j, i in enumerate(kept)}
    meta["state_only"] = True
    meta["acc_start"] = meta["iteration"]
    meta["acc_leaf_indices"] = []
    _atomic_savez(dst, meta, payload)


@contextlib.contextmanager
def _open(path: str):
    """The npz; a file that is no longer a zip archive (a torn write) is
    a corrupt checkpoint."""
    try:
        z = np.load(path)
    except zipfile.BadZipFile as e:
        raise CheckpointCorruptError(f"{path}: not a readable checkpoint "
                                     f"({e})", path=path) from e
    with z:
        yield z


def _read_meta(z, path: str) -> dict:
    meta = json.loads(bytes(z["__meta__"]).decode())
    if meta["version"] not in _LOADABLE_VERSIONS:
        raise ValueError(
            f"{path}: checkpoint format v{meta['version']} != "
            f"v{_FORMAT_VERSION} (loadable: {sorted(_LOADABLE_VERSIONS)})")
    return meta


def verify_checkpoint(path: str) -> dict:
    """Template-free integrity check: a readable npz, a loadable format
    version, every payload entry matching its recorded CRC32.  Returns the
    meta with ``crc_verified`` set; raises :class:`CheckpointCorruptError`
    on a CRC mismatch."""
    with _open(path) as z:
        meta = _read_meta(z, path)
        for name in z.files:
            if name != "__meta__":
                _read_leaf(z, meta, name, path)
    meta["crc_verified"] = bool(meta.get("leaf_crc"))
    return meta


def scan_generations(path: str) -> list:
    """``(path, iteration, error)`` for the live file and every ``.bakK``,
    newest first: ``error`` is None for a CRC-clean generation, else the
    verification failure (``iteration`` -1)."""
    out = []
    for p in retained_checkpoints(path):
        try:
            meta = verify_checkpoint(p)
            out.append((p, int(meta["iteration"]), None))
        except (OSError, ValueError, KeyError) as e:
            out.append((p, -1, e))
    return out


def read_checkpoint_meta(path: str) -> dict:
    """Only the metadata entry: cheap, for compatibility checks before any
    leaf is read."""
    with _open(path) as z:
        return _read_meta(z, path)


def load_checkpoint(path: str, template: dict) -> Tuple[dict, dict]:
    """``({leaf name: numpy array}, meta)``.  ``template`` is
    :func:`carry_template`'s: every leaf is CRC-checked, then its shape
    checked against the template, so a config/data mismatch fails loudly.
    A light file has no accumulators: the caller restarts them at zero
    (accumulation restarts at ``meta["iteration"]``)."""
    with _open(path) as z:
        meta = _read_meta(z, path)
        # the template is carry_template's: its keys in full-file order
        names = [k for k in template if not (meta.get("state_only")
                                             and k in ACC_LEAVES)]
        leaves = {}
        for i, name in enumerate(names):
            arr = _read_leaf(z, meta, f"leaf_{i}", path)
            shape, _ = template[name]
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(
                    f"checkpoint leaf {i} ({name}) shape {arr.shape} != "
                    f"expected {shape} - config/data mismatch?")
            leaves[name] = arr
    return leaves, meta


def checkpoint_compatible(meta: dict, cfg: FitConfig, fingerprint: str, *,
                          ignore_chains: bool = False) -> Optional[str]:
    """None if resumable under ``cfg``, else a human-readable refusal: the
    JAX package's rules, after the port's own - the file's chains must
    come from the port's Philox streams."""
    if meta.get("rng") != RNG_STREAMS:
        return (f"the checkpoint names no {RNG_STREAMS!r} streams (meta "
                "'rng'): it was written by the JAX package, whose chains "
                "come from threefry keys and cannot be continued on the "
                "port's Philox streams as the same chain")
    saved = _config_from_json(meta["config"])
    if saved.model != cfg.model:
        return f"model config changed: {saved.model} != {cfg.model}"
    if saved.run.seed != cfg.run.seed:
        return f"seed changed: {saved.run.seed} != {cfg.run.seed}"
    if (saved.run.burnin, saved.run.thin) != (cfg.run.burnin, cfg.run.thin):
        return ("burnin/thin changed (which draws count as saved depends on "
                "them)")
    # the accumulators are raw sums, so a LONGER mcmc extends the chain;
    # only shrinking below what already ran is unresumable
    if cfg.run.total_iters < meta["iteration"]:
        return (f"checkpoint is at iteration {meta['iteration']} but the "
                f"schedule ends at {cfg.run.total_iters} - a chain cannot "
                "be shrunk (saved draws are already summed in)")
    if saved.run.store_draws and saved.run.num_saved != cfg.run.num_saved:
        return ("mcmc length changed with store_draws=True (the draw "
                "buffers are statically sized by num_saved)")
    if not ignore_chains and saved.run.num_chains != cfg.run.num_chains:
        return (f"checkpoint has num_chains={saved.run.num_chains}, run "
                f"configured {cfg.run.num_chains}; pass "
                f"num_chains={saved.run.num_chains} to match the checkpoint")
    if saved.run.store_draws != cfg.run.store_draws:
        return (f"store_draws changed: {saved.run.store_draws} != "
                f"{cfg.run.store_draws} (the carry gains/loses the "
                "draw-buffer leaves)")
    # one accumulated posterior must come from one sweep precision
    if saved.backend.compute_dtype != cfg.backend.compute_dtype:
        return (f"compute_dtype changed: checkpoint ran "
                f"{saved.backend.compute_dtype!r}, resume requests "
                f"{cfg.backend.compute_dtype!r} (one accumulated "
                "posterior must come from one sweep precision)")
    # backend.sse_mode is deliberately not compared (as in the JAX
    # package): both psi strategies draw from the same conditional law
    if meta["fingerprint"] != fingerprint:
        return "data fingerprint mismatch - resuming on different data"
    return None


def _donor_template(template: dict, run_chains: int,
                    donor_chains: int) -> dict:
    """A ``run_chains``-chain template rewritten to the donor's chain
    count: a pure leading-axis edit (the chain-axis convention)."""
    out = {}
    for k, (shape, dtype) in template.items():
        core = tuple(shape[1:]) if run_chains > 1 else tuple(shape)
        out[k] = (((donor_chains,) + core) if donor_chains > 1 else core,
                  dtype)
    return out


def load_checkpoint_elastic(path: str, template: dict, num_chains: int, *,
                            births: Optional[list] = None
                            ) -> Tuple[dict, dict, dict]:
    """Adopt a full checkpoint written at another chain count onto
    ``num_chains`` chains: the port of the JAX package's
    ``load_checkpoint_elastic``, single-process.

    A shrink C -> C' keeps the first C' chains' leaves verbatim and folds
    the dropped chains' accumulators into chain 0 in the JAX package's
    order, ``a[0] + a[C':].sum(axis=0)``; the draws they held are counted
    in ``fold_draws``.  A grow keeps every donor chain verbatim and takes
    the new chains' leaves from ``births`` (one ``{leaf: array}`` per new
    chain, no chain axis: initial states on a fresh lineage), with zero
    accumulators, the donor's iteration and the adoption iteration as
    their window start.

    ``template`` is :func:`carry_template`'s for ``num_chains`` chains.
    Returns ``(leaves shaped for num_chains, meta, info)``; ``info`` holds
    from/to chains, kept, dropped, birthed, ``fold_draws``,
    ``chain_acc_starts``, the donor's ``elastic_lineage`` and topology.
    Light donors and ``store_draws`` donors are refused (ValueError, the
    JAX package's messages)."""
    meta = read_checkpoint_meta(path)
    saved = _config_from_json(meta["config"])
    donor_chains = int(saved.run.num_chains)
    new_c = int(num_chains)
    if meta.get("state_only"):
        raise ValueError(
            "elastic resume needs a FULL checkpoint: a state-only (light) "
            "file carries no accumulators, so a dropped chain's draws "
            "cannot be folded into the pooled posterior - resume it at "
            f"num_chains={donor_chains} first, or start fresh")
    if saved.run.store_draws:
        raise ValueError(
            "elastic resume refuses store_draws=True checkpoints: the "
            "per-draw buffers are statically sized per chain and cannot "
            "be re-chained - resume at the original chain count "
            f"({donor_chains}) instead")
    leaves, meta = load_checkpoint(
        path, _donor_template(template, new_c, donor_chains))
    starts, fold, lineage = elastic_meta(meta, donor_chains)
    it = int(meta["iteration"])
    burnin, thin = int(saved.run.burnin), int(saved.run.thin)

    def window(a):
        return (num_saved_draws(it, burnin, thin)
                - num_saved_draws(int(a), burnin, thin))

    def chains(a):
        return a[None] if donor_chains == 1 else a

    if new_c < donor_chains:
        out = {}
        for k, a in leaves.items():
            a = np.array(chains(np.asarray(a)), copy=True)
            if k in ACC_LEAVES:
                a[0] = a[0] + a[new_c:].sum(axis=0, dtype=a.dtype)
            a = a[:new_c]
            out[k] = a[0] if new_c == 1 else a
        leaves = out
        fold = fold + sum(window(starts[c])
                          for c in range(new_c, donor_chains))
        starts = starts[:new_c]
    elif new_c > donor_chains:
        if births is None or len(births) != new_c - donor_chains:
            raise ValueError(
                f"growing {donor_chains} -> {new_c} chains requires the "
                f"{new_c - donor_chains} births' initial leaves")
        out = {}
        for k, a in leaves.items():
            a = chains(np.asarray(a))
            if k == "iteration":
                born = [np.full((), it, a.dtype)] * len(births)
            elif k in ACC_LEAVES:
                born = [np.zeros(a.shape[1:], a.dtype)] * len(births)
            else:
                born = [np.asarray(b[k], a.dtype) for b in births]
            out[k] = np.concatenate([a, np.stack(born)])
        leaves = out
        starts = starts + [it] * (new_c - donor_chains)
    info = {
        "from_chains": donor_chains, "to_chains": new_c,
        "kept": min(donor_chains, new_c),
        "dropped": max(0, donor_chains - new_c),
        "birthed": max(0, new_c - donor_chains),
        "fold_draws": int(fold),
        "chain_acc_starts": [int(a) for a in starts],
        "elastic_lineage": int(lineage),
        "from_topology": meta.get("topology"),
    }
    return leaves, meta, info


class AsyncCheckpointWriter:
    """Write-behind saves: :meth:`submit` snapshots the chains' carries
    (:class:`Snapshot`: a side-stream copy into pinned host memory) and a
    background thread waits for the copy and writes the file, so the next
    chunk runs while the save lands.

    At most one save is in flight: ``submit`` joins the previous one
    first.  :meth:`wait` must be called before the results are used (it
    makes the last file durable); a failed save re-raises there or at the
    next submit.  :meth:`poll_error` shows a stored failure without
    blocking.  ``last_save_seconds`` is the wall of the latest completed
    save (the copy's wait and the write) - what
    ``checkpoint_every_chunks="auto"`` sizes its cadence from."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_save_seconds: Optional[float] = None

    def submit(self, save_fn: Callable[..., None], path: str, carries: list,
               cfg: FitConfig, *, fingerprint: str, **save_kwargs) -> None:
        self.wait()
        snap = Snapshot(carries, state_only=bool(save_kwargs.get(
            "state_only")))

        def run():
            t0 = time.perf_counter()
            try:
                save_fn(path, snap.wait(), cfg, fingerprint=fingerprint,
                        **save_kwargs)
                self.last_save_seconds = time.perf_counter() - t0
            except BaseException as e:   # surfaced by wait()/poll_error()
                self._error = e

        # non-daemon: the interpreter joins it at exit, so an abandoned
        # writer still finishes its file instead of dying inside np.savez
        self._thread = threading.Thread(target=run,
                                        name="dcfm-checkpoint-writer")
        self._thread.start()

    def poll_error(self) -> Optional[BaseException]:
        """A stored background failure, not consumed (wait() raises it)."""
        return self._error

    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        t = self._thread
        if t is not None:
            t.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e
