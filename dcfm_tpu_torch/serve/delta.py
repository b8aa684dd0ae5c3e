"""Delta artifacts: ship only the panels a refit actually changed.

The port's copy of ``dcfm_tpu/serve/delta.py``: a delta either package
writes is byte for byte the other's from the same base and candidate,
and each package materializes the other's.

The conquer output is O(p^2) but a warm refit perturbs it unevenly -
converged shards re-enter the Gibbs sweep bitwise (the warm-start graft) and
their panels come out byte-identical, yet the online loop re-ships the
full int8 panel set every generation.  This module encodes a candidate
artifact as a *delta* against the generation currently serving, using
the per-panel CRC32 tables both artifacts already carry (the tables
identify unchanged panels byte-exactly), so promotion cost and fleet
re-warm scale with posterior drift, not p^2.

Format (a directory; ``delta.json`` is written LAST so a torn delta
refuses to open, exactly like the full artifact's ``meta.json``)::

    delta/
      mean_delta_q8.bin     int8 (n_changed_mean, P, P) C-order - the
                            candidate's CHANGED mean panels, packed in
                            ascending canonical pair order
      sd_delta_q8.bin       same for the SD panels (when the artifact
                            has them)
      maps.npz              the candidate's maps, copied VERBATIM -
                            scales are O(p) and a per-panel scale diff
                            cannot pay for the bookkeeping, so scale and
                            preprocess-map changes always ship whole
      candidate.meta.json   the candidate's meta.json, copied VERBATIM -
                            materialization re-lands these exact bytes,
                            which is what makes the reconstruction
                            byte-identical (CRC tables, fingerprint,
                            provenance and all)
      delta.json            format tag, base/candidate fingerprints,
                            changed-pair index, payload CRCs

The byte-identity contract: ``materialize_delta(base, delta)``
reconstructs a directory whose panel binaries, ``maps.npz`` and
``meta.json`` are byte-for-byte the candidate's.  Unchanged panels are
copied from the base (their CRCs pin them to the candidate's bytes),
changed panels come from the delta payload, and the two metadata files
are verbatim copies.  Every materialized panel is CRC-verified against
the candidate's recorded table BEFORE the meta lands, so a corrupt base
or a torn copy refuses cleanly - the meta-written-last discipline of
the artifact writer applied to reconstruction.

The changed-pair index is a *shipping* predicate (panel bytes differ);
the serving engine's memmap-adoption predicate is stricter (panel bytes
OR the panel's scale differ - see ``serve/engine.py``), because a
scale-only change alters dequantized values without touching panel
bytes.  Shipping does not care - maps travel whole - but adoption must.

Fault seams (``resilience/faults.py``): delta exports count writes
under target ``"delta"`` (io_error / io_delay / bit_flip / torn_write),
materialization counts under the existing ``"artifact"`` target and
brackets its payload landing with the ``delta_materialize`` kill point,
so the chaos harness can SIGKILL mid-materialization and assert the
pointer and serving generation never moved.

Everything here is NumPy + stdlib - the serving plane's no-jax rule.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import zlib
from typing import Optional, Union

import numpy as np

from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.resilience.faults import fault_event, fault_plan
from dcfm_tpu_torch.serve.artifact import (ArtifactCorruptError, ArtifactError,
                                     MAPS_FILE, META_FILE,
                                     MEAN_PANELS_FILE, SD_PANELS_FILE,
                                     PosteriorArtifact, panel_crc32)

DELTA_FORMAT = "dcfm-posterior-delta"
DELTA_VERSION = 1

DELTA_META_FILE = "delta.json"
CANDIDATE_META_FILE = "candidate.meta.json"
MEAN_DELTA_FILE = "mean_delta_q8.bin"
SD_DELTA_FILE = "sd_delta_q8.bin"

_KIND_FILES = {"mean": MEAN_DELTA_FILE, "sd": SD_DELTA_FILE}


class DeltaError(ArtifactError):
    """Malformed / inapplicable delta (missing files, shape mismatch,
    a base or candidate without the CRC tables a diff needs).  Callers
    that hold a full candidate treat this as "fall back to a full
    promotion", never as a refusal loop."""


class DeltaBaseMismatchError(DeltaError):
    """The artifact offered as the base is not the one this delta was
    written against (fingerprint mismatch) - applying it would splice
    panels from two unrelated posteriors.  The online loop records a
    full-promotion fallback on this; a replica re-syncs instead."""


def _file_crc32(path: str) -> int:
    """CRC32 of a whole file's bytes (the delta's self-integrity record
    for the verbatim-copied metadata payloads)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _require_crc_table(art: PosteriorArtifact, role: str) -> dict:
    crc = art.meta.get("panel_crc") or {}
    kinds = ("mean", "sd") if art.has_sd else ("mean",)
    if not all(k in crc for k in kinds):
        raise DeltaError(
            f"{art.path}: {role} artifact has no complete panel CRC table "
            "(pre-integrity export or sparse synthetic) - a delta cannot "
            "prove which panels changed; ship the full artifact")
    return crc


def changed_pairs(base: PosteriorArtifact,
                  candidate: PosteriorArtifact) -> dict:
    """The per-kind ascending index of pairs whose panel BYTES differ,
    straight from the two recorded CRC tables (no panel reads).  Raises
    :class:`DeltaError` when the artifacts are not diffable (shape or
    SD-presence mismatch, missing CRC tables)."""
    if (base.g, base.P, base.has_sd) != (candidate.g, candidate.P,
                                         candidate.has_sd):
        raise DeltaError(
            f"base (g={base.g}, P={base.P}, sd={base.has_sd}) and "
            f"candidate (g={candidate.g}, P={candidate.P}, "
            f"sd={candidate.has_sd}) are different shapes - a delta only "
            "applies between same-shape generations; ship the full "
            "artifact")
    bcrc = _require_crc_table(base, "base")
    ccrc = _require_crc_table(candidate, "candidate")
    out = {}
    for kind in (("mean", "sd") if base.has_sd else ("mean",)):
        b = np.asarray(bcrc[kind], np.int64)
        c = np.asarray(ccrc[kind], np.int64)
        out[kind] = np.flatnonzero(b != c).astype(np.int64)
    return out


@dataclasses.dataclass
class DeltaArtifact:
    """An opened delta: packed changed panels + the verbatim candidate
    metadata, validated (sizes, index bounds) but not yet CRC-verified -
    call :meth:`verify` (materialize does) before trusting the bytes."""

    path: str
    meta: dict
    g: int
    P: int
    has_sd: bool
    n_pairs: int
    base_fingerprint: str
    candidate_fingerprint: str
    changed: dict                      # kind -> ascending (n_changed,) int64
    mean_delta: np.ndarray             # (n_changed, P, P) int8 (memmap)
    sd_delta: Optional[np.ndarray]

    @property
    def panels_changed(self) -> int:
        return sum(len(v) for v in self.changed.values())

    @property
    def bytes_shipped(self) -> int:
        return int(self.meta["bytes_shipped"])

    @property
    def full_bytes(self) -> int:
        return int(self.meta["full_bytes"])

    @property
    def candidate_name(self) -> str:
        """The candidate directory name recorded at export - the default
        materialization target inside a promotion root."""
        return str(self.meta.get("candidate") or "")

    @classmethod
    def open(cls, path: str) -> "DeltaArtifact":
        meta_path = os.path.join(path, DELTA_META_FILE)
        if not os.path.exists(meta_path):
            raise DeltaError(
                f"{path} is not a delta artifact (no {DELTA_META_FILE}; a "
                "crash mid-export leaves the meta unwritten - re-export)")
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("format") != DELTA_FORMAT:
            raise DeltaError(
                f"{path}: unrecognized delta format {meta.get('format')!r} "
                f"(expected {DELTA_FORMAT!r})")
        if meta.get("version") != DELTA_VERSION:
            raise DeltaError(
                f"{path}: delta format v{meta.get('version')} != "
                f"v{DELTA_VERSION} supported by this library")
        g, P = int(meta["g"]), int(meta["P"])
        n_pairs = g * (g + 1) // 2
        has_sd = bool(meta.get("has_sd"))
        for name in (CANDIDATE_META_FILE, MAPS_FILE):
            if not os.path.exists(os.path.join(path, name)):
                raise DeltaError(f"{path}: missing payload file {name}")
        changed, panels = {}, {}
        for kind in (("mean", "sd") if has_sd else ("mean",)):
            idx = np.asarray(meta["changed"].get(kind, []), np.int64)
            if idx.size and not (np.all(np.diff(idx) > 0)
                                 and 0 <= idx[0] and idx[-1] < n_pairs):
                raise DeltaError(
                    f"{path}: changed[{kind!r}] index is not a strictly "
                    f"ascending subset of [0, {n_pairs})")
            changed[kind] = idx
            fp = os.path.join(path, _KIND_FILES[kind])
            want = idx.size * P * P
            have = os.path.getsize(fp) if os.path.exists(fp) else -1
            if idx.size == 0:
                # an empty memmap is illegal; nothing changed, no file
                # bytes required
                panels[kind] = np.zeros((0, P, P), np.int8)  # dcfm: ignore[DCFM1501] - zero-length placeholder, no bytes materialized
                continue
            if have != want:
                raise DeltaError(
                    f"{path}/{_KIND_FILES[kind]}: {have} bytes != expected "
                    f"{want} ({idx.size} changed panels, P={P}) - "
                    "truncated or mismatched delta")
            panels[kind] = np.memmap(fp, dtype=np.int8, mode="r",
                                     shape=(idx.size, P, P))
        return cls(path=path, meta=meta, g=g, P=P, has_sd=has_sd,
                   n_pairs=n_pairs,
                   base_fingerprint=str(meta["base_fingerprint"]),
                   candidate_fingerprint=str(meta["candidate_fingerprint"]),
                   changed=changed, mean_delta=panels["mean"],
                   sd_delta=panels.get("sd"))

    def verify(self) -> None:
        """CRC-verify the delta's OWN payload: every packed panel against
        the per-slot CRCs recorded at export, and the two verbatim-copied
        metadata files against their whole-file CRCs.  A single bit-flip
        anywhere in the delta raises the typed
        :class:`~dcfm_tpu_torch.serve.artifact.ArtifactCorruptError` - callers
        (materialize) refuse BEFORE any reconstructed byte can serve."""
        pc = self.meta.get("payload_crc") or {}
        for kind, panels in (("mean", self.mean_delta),
                             ("sd", self.sd_delta)):
            if panels is None:
                continue
            crcs = np.asarray(pc.get(kind, []), np.int64)
            if crcs.shape != (panels.shape[0],):
                raise DeltaError(
                    f"{self.path}: payload_crc[{kind!r}] has {crcs.shape} "
                    f"entries != {panels.shape[0]} packed panels")
            for slot in range(panels.shape[0]):
                got = panel_crc32(panels[slot])
                if got != int(crcs[slot]):
                    pair = int(self.changed[kind][slot])
                    raise ArtifactCorruptError(
                        f"{self.path}: packed {kind} panel for pair {pair} "
                        f"fails its CRC32 (stored {int(crcs[slot]):#010x}, "
                        f"computed {got:#010x}) - the delta bytes are "
                        "corrupt; re-export or re-pull it",
                        panel=pair, kind=kind)
        for key, name in (("candidate_meta", CANDIDATE_META_FILE),
                          ("maps", MAPS_FILE)):
            want = pc.get(key)
            got = _file_crc32(os.path.join(self.path, name))
            if want is None or got != int(want):
                raise ArtifactCorruptError(
                    f"{self.path}: {name} fails its recorded CRC32 - the "
                    "delta metadata payload is corrupt; re-export or "
                    "re-pull it", kind=key)


def write_delta_artifact(candidate: Union[str, PosteriorArtifact, object],
                         base: PosteriorArtifact, out: str) -> DeltaArtifact:
    """Diff ``candidate`` against ``base`` and write the delta to ``out``.

    ``candidate`` is a full-artifact directory path, an opened
    :class:`PosteriorArtifact`, or a ``FitResult`` (exported first to
    ``out + ".candidate"`` - the full artifact must exist somewhere for
    the byte-identity contract to mean anything; the caller owns that
    staging directory afterwards).

    The changed-pair index comes straight from the two recorded CRC
    tables; only those panels' bytes are packed.  ``maps.npz`` and
    ``meta.json`` are copied verbatim (see the module docstring for
    why).  ``delta.json`` is written LAST, atomically - a crash
    mid-export leaves a directory :meth:`DeltaArtifact.open` refuses.

    Raises :class:`DeltaError` when the pair is not diffable (shape
    mismatch, missing CRC tables) - the caller's cue to ship the full
    artifact instead.
    """
    if isinstance(candidate, str):
        cand = PosteriorArtifact.open(candidate)
    elif isinstance(candidate, PosteriorArtifact):
        cand = candidate
    else:
        from dcfm_tpu_torch.serve.artifact import export_fit_result
        cand = export_fit_result(candidate, out + ".candidate")
    changed = changed_pairs(base, cand)
    if base.fingerprint == cand.fingerprint:
        # legal (an idempotent re-promotion ships an empty delta) but
        # worth noting: every changed index is empty by construction
        assert all(v.size == 0 for v in changed.values())

    os.makedirs(out, exist_ok=True)
    # re-export over an existing delta: drop the old meta BEFORE any
    # payload write, so every partially-written state is unopenable
    dmeta_path = os.path.join(out, DELTA_META_FILE)
    if os.path.exists(dmeta_path):
        os.unlink(dmeta_path)

    # chaos seam (resilience/faults.py, target "delta"): failing/delayed
    # I/O before any byte lands, bit-flips AFTER the payload CRCs are
    # computed, torn packed files after the write
    plan = fault_plan()
    count = plan.on_write("delta", out) if plan else 0

    packed = {}
    payload_crc = {}
    for kind in changed:
        panels, _ = cand.panels(kind)
        packed[kind] = np.ascontiguousarray(
            np.asarray(panels)[changed[kind]], np.int8)
        payload_crc[kind] = [int(panel_crc32(q)) for q in packed[kind]]
    if plan:
        mutated = plan.mutate_payload(
            "delta", out, count,
            {_KIND_FILES[k]: v for k, v in packed.items()})
        packed = {k: mutated[_KIND_FILES[k]] for k in packed}

    for kind in packed:
        fp = os.path.join(out, _KIND_FILES[kind])
        if packed[kind].shape[0] == 0:
            if os.path.exists(fp):
                os.unlink(fp)      # stale payload from a prior export
            continue
        with open(fp, "wb") as f:
            np.ascontiguousarray(packed[kind], np.int8).tofile(f)
    if plan and packed["mean"].shape[0]:
        plan.after_replace("delta", os.path.join(out, MEAN_DELTA_FILE),
                           count)
    shutil.copyfile(os.path.join(cand.path, META_FILE),
                    os.path.join(out, CANDIDATE_META_FILE))
    shutil.copyfile(os.path.join(cand.path, MAPS_FILE),
                    os.path.join(out, MAPS_FILE))
    payload_crc["candidate_meta"] = _file_crc32(
        os.path.join(out, CANDIDATE_META_FILE))
    payload_crc["maps"] = _file_crc32(os.path.join(out, MAPS_FILE))

    panels_changed = sum(int(v.size) for v in changed.values())
    panel_bytes = panels_changed * cand.P * cand.P
    meta_bytes = (os.path.getsize(os.path.join(out, CANDIDATE_META_FILE))
                  + os.path.getsize(os.path.join(out, MAPS_FILE)))
    full_panel_bytes = cand.n_pairs * cand.P * cand.P * (2 if cand.has_sd
                                                         else 1)
    meta = {
        "format": DELTA_FORMAT,
        "version": DELTA_VERSION,
        "g": int(cand.g),
        "P": int(cand.P),
        "has_sd": bool(cand.has_sd),
        "base_fingerprint": base.fingerprint,
        "candidate_fingerprint": cand.fingerprint,
        "candidate": os.path.basename(os.path.normpath(cand.path)),
        "changed": {k: [int(i) for i in v] for k, v in changed.items()},
        "payload_crc": payload_crc,
        # what this delta ships vs what a full promotion would: packed
        # panels + the verbatim metadata payloads (delta.json itself is
        # O(changed) and excluded from both sides)
        "bytes_shipped": int(panel_bytes + meta_bytes),
        "full_bytes": int(full_panel_bytes + meta_bytes),
    }
    tmp = dmeta_path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, dmeta_path)
    record("delta_export", path=os.path.basename(os.path.normpath(out)),
           base_fingerprint=base.fingerprint,
           candidate_fingerprint=cand.fingerprint,
           panels_changed=panels_changed,
           panels_total=cand.n_pairs * (2 if cand.has_sd else 1),
           bytes_shipped=meta["bytes_shipped"],
           full_bytes=meta["full_bytes"])
    return DeltaArtifact.open(out)


def materialize_delta(base: Union[str, PosteriorArtifact],
                      delta: Union[str, DeltaArtifact],
                      out: str) -> PosteriorArtifact:
    """Reconstruct the candidate from ``base`` + ``delta`` into ``out``,
    byte-identical to the artifact the delta was written from.

    Order of operations is the write-side discipline run in reverse
    trust: (1) the delta's own payload CRCs are verified FIRST - a
    bit-flipped delta refuses before a single byte lands; (2) any
    existing ``out/meta.json`` is invalidated; (3) panel files land
    (base bytes, changed panels patched over them); (4) EVERY
    materialized panel is CRC-verified against the candidate's recorded
    table - a corrupt base or a torn copy refuses here, with ``out``
    still unopenable; (5) the candidate's ``meta.json`` bytes are
    written last, atomically.  A SIGKILL at any point leaves either no
    ``out`` meta (unopenable - clean retry re-materializes) or the
    finished artifact.

    Raises :class:`DeltaBaseMismatchError` when ``base`` is not the
    artifact the delta names - the caller falls back to pulling the
    full candidate.
    """
    if isinstance(base, str):
        base = PosteriorArtifact.open(base)
    if isinstance(delta, str):
        delta = DeltaArtifact.open(delta)
    if base.fingerprint != delta.base_fingerprint:
        raise DeltaBaseMismatchError(
            f"{delta.path}: delta was written against base "
            f"{delta.base_fingerprint} but {base.path} is "
            f"{base.fingerprint} - applying it would splice two unrelated "
            "posteriors; pull the full candidate instead")
    if (base.g, base.P, base.has_sd) != (delta.g, delta.P, delta.has_sd):
        raise DeltaError(
            f"{delta.path}: delta shape (g={delta.g}, P={delta.P}, "
            f"sd={delta.has_sd}) does not match base {base.path}")
    delta.verify()
    with open(os.path.join(delta.path, CANDIDATE_META_FILE), "rb") as f:
        cand_meta_bytes = f.read()
    cand_meta = json.loads(cand_meta_bytes)
    cand_crc = cand_meta.get("panel_crc") or {}

    n_pairs, P = base.n_pairs, base.P
    os.makedirs(out, exist_ok=True)
    # chaos seam: materialization is an artifact write - same target as
    # write_artifact, plus the delta_materialize kill point below
    plan = fault_plan()
    count = plan.on_write("artifact", out) if plan else 0
    meta_path = os.path.join(out, META_FILE)
    if os.path.exists(meta_path):
        os.unlink(meta_path)
    if not base.has_sd and os.path.exists(os.path.join(out, SD_PANELS_FILE)):
        os.unlink(os.path.join(out, SD_PANELS_FILE))

    specs = [("mean", MEAN_PANELS_FILE, delta.mean_delta)]
    if base.has_sd:
        specs.append(("sd", SD_PANELS_FILE, delta.sd_delta))
    for kind, name, packed in specs:
        dst = os.path.join(out, name)
        if os.path.exists(dst):
            # fresh inode, never rewrite-in-place: a prior epoch's engine
            # may still hold a memmap of this inode (see
            # begin_streamed_artifact)
            os.unlink(dst)
        shutil.copyfile(os.path.join(base.path, name), dst)
        idx = delta.changed[kind]
        if idx.size:
            mm = np.memmap(dst, dtype=np.int8, mode="r+",
                           shape=(n_pairs, P, P))
            mm[idx] = np.asarray(packed)
            mm.flush()
            del mm
        if kind == "mean":
            # a kill HERE leaves panel bytes without a meta: unopenable
            fault_event("delta_materialize")
            if plan:
                plan.after_replace("artifact", dst, count)
    shutil.copyfile(os.path.join(delta.path, MAPS_FILE),
                    os.path.join(out, MAPS_FILE))

    # full sweep against the CANDIDATE's table before the meta lands -
    # this is what catches a base whose unchanged panels rotted on disk
    for kind, name, _ in specs:
        crcs = np.asarray(cand_crc.get(kind, []), np.int64)
        if crcs.shape != (n_pairs,):
            raise DeltaError(
                f"{delta.path}: candidate meta has no complete "
                f"panel_crc[{kind!r}] table - cannot prove the "
                "reconstruction; pull the full candidate")
        mm = np.memmap(os.path.join(out, name), dtype=np.int8, mode="r",
                       shape=(n_pairs, P, P))
        for pair in range(n_pairs):
            got = panel_crc32(mm[pair])
            if got != int(crcs[pair]):
                raise ArtifactCorruptError(
                    f"{out}: materialized {kind} panel {pair} fails the "
                    f"candidate's CRC32 (stored {int(crcs[pair]):#010x}, "
                    f"computed {got:#010x}) - the base bytes rotted or "
                    "the copy tore; the reconstruction is refused and "
                    f"{out} stays unopenable", panel=pair, kind=kind)
        del mm

    tmp = meta_path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(cand_meta_bytes)
    os.replace(tmp, meta_path)
    return PosteriorArtifact.open(out)
