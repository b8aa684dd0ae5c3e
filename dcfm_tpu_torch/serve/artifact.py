"""Durable, memory-mapped posterior artifact: fit once, serve forever.

The port's copy of the NumPy/stdlib part of ``dcfm_tpu/serve/artifact.py``,
in the same format (``dcfm-posterior-artifact`` v1): an artifact exported
here opens under the JAX package's ``PosteriorArtifact`` and the other way
round.  A directory::

    artifact/
      mean_q8.bin   int8  (n_pairs, P, P) C-order  - memmapped
      sd_q8.bin     int8  (n_pairs, P, P) C-order  - memmapped, optional
      maps.npz      per-panel scales + preprocess maps (O(p), loaded whole)
      meta.json     format tag, version, shape, per-panel CRC32s,
                    provenance, fingerprint - written LAST

The panels are the packed g(g+1)/2 upper-triangle panels in the canonical
triu order the device accumulates and the native assembler consumes,
quantized with the quant8 link's max-abs rule (runtime/fetch.cast_for_link;
:func:`quantize_panels` is its host twin).  ``meta.json`` is removed first
and written last, so a half-written artifact fails to open instead of
serving garbage.

Three export sources, no refit: :func:`export_fit_result` (a FitResult),
the streamed export (:func:`begin_streamed_artifact` hands the streamed
fetch its landing memmaps, :func:`finalize_streamed_artifact` completes
the artifact) and :func:`export_from_checkpoint` (a checkpoint file of
either package and the data matrix); :func:`export_main` is the CLI's
``export``.  :func:`create_sparse_artifact` synthesizes a hole-backed
artifact for capacity tests.  Each finished artifact is an
``artifact_write`` flight-recorder event (obs/recorder.py; ``source``
"export" or "stream").  :func:`write_artifact` carries the fault plan's
``artifact`` seam (resilience/faults.py).  Not ported (ROADMAP Queue A
item 7): ``.procK-of-N`` checkpoint sets and the cooperative exports.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from typing import Optional

import numpy as np

from dcfm_tpu_torch.config import FitConfig, validate
from dcfm_tpu_torch.models.state import num_upper_pairs
from dcfm_tpu_torch.obs.recorder import record
from dcfm_tpu_torch.resilience.faults import fault_plan
from dcfm_tpu_torch.runtime.fetch import accumulator_window
from dcfm_tpu_torch.runtime.resume import refuse_multiprocess_sets
from dcfm_tpu_torch.utils.checkpoint import (
    carry_template, config_from_checkpoint_meta, data_fingerprint,
    elastic_meta, load_checkpoint, read_checkpoint_meta)
from dcfm_tpu_torch.utils.estimate import assemble_from_q8
from dcfm_tpu_torch.utils.preprocess import PreprocessResult, preprocess

ARTIFACT_FORMAT = "dcfm-posterior-artifact"
ARTIFACT_VERSION = 1

META_FILE = "meta.json"
MAPS_FILE = "maps.npz"
MEAN_PANELS_FILE = "mean_q8.bin"
SD_PANELS_FILE = "sd_q8.bin"


class ArtifactError(ValueError):
    """Malformed / unreadable artifact (missing files, size mismatch)."""


class ArtifactVersionError(ArtifactError):
    """Artifact format version this library cannot serve."""


class ArtifactCorruptError(ArtifactError):
    """A panel failed its recorded CRC32: the memmapped bytes are not the
    bytes the export wrote.  ``panel`` is the canonical triu pair index."""

    def __init__(self, message: str, *, panel: int = -1, kind: str = ""):
        super().__init__(message)
        self.panel = panel
        self.kind = kind


def panel_crc32(panel: np.ndarray) -> int:
    """CRC32 of one int8 panel's raw bytes."""
    return zlib.crc32(np.ascontiguousarray(panel).reshape(-1).view(np.uint8))


def _num_pairs(g: int) -> int:
    return g * (g + 1) // 2


def artifact_fingerprint(meta: dict) -> str:
    """Content fingerprint of an artifact from its metadata alone: shape
    fields, provenance and the per-panel CRC32s (which pin the payload
    bytes); prefixed ``weak-`` when no panel CRCs are recorded."""
    crc = meta.get("panel_crc") or {}
    basis = {
        "g": meta.get("g"), "P": meta.get("P"),
        "p_original": meta.get("p_original"),
        "n_pad": meta.get("n_pad"), "has_sd": meta.get("has_sd"),
        "provenance": meta.get("provenance") or {},
        "panel_crc": crc,
    }
    digest = hashlib.sha256(
        json.dumps(basis, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    return digest if crc else f"weak-{digest}"


def quantize_panels(upper: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of the quant8 link cast (runtime/fetch.cast_for_link):
    max-abs int8 per panel, ``q = round(u * 127/scale)``, in the same
    float32 operation order and with the same round-half-even, so a
    float32 fetch exports the bytes a quant8 fetch of the chain would."""
    upper = np.ascontiguousarray(upper, np.float32)
    scale = np.max(np.abs(upper), axis=(1, 2)).astype(np.float32)
    safe = np.where(scale > 0, scale, np.float32(1.0)).astype(np.float32)
    q = np.round(upper * (np.float32(127.0) / safe)[:, None, None]).astype(
        np.int8)
    return q, scale


@dataclasses.dataclass
class PosteriorArtifact:
    """An opened artifact: memmapped panels + in-RAM O(p) maps.

    ``pre`` is a shape-only :class:`PreprocessResult` (its ``data`` is an
    empty (g, 0, P) array) for the coordinate machinery
    (``caller_to_shard_index``, ``assembly_maps``)."""

    path: str
    meta: dict
    g: int
    P: int
    n_pairs: int
    p_original: int
    n_pad: int
    has_sd: bool
    mean_panels: np.ndarray            # (n_pairs, P, P) int8 memmap
    mean_scale: np.ndarray             # (n_pairs,) float32
    sd_panels: Optional[np.ndarray]    # (n_pairs, P, P) int8 memmap or None
    sd_scale: Optional[np.ndarray]
    pre: PreprocessResult
    # per-panel CRC32s from meta.json ({"mean": (n_pairs,), ...} int64
    # arrays), or {} for artifacts without them
    panel_crc: dict = dataclasses.field(default_factory=dict)

    @property
    def p_used(self) -> int:
        return self.g * self.P

    @property
    def fingerprint(self) -> str:
        return (self.meta.get("fingerprint")
                or artifact_fingerprint(self.meta))

    @classmethod
    def open(cls, path: str) -> "PosteriorArtifact":
        meta_path = os.path.join(path, META_FILE)
        if not os.path.exists(meta_path):
            raise ArtifactError(
                f"{path} is not a posterior artifact (no {META_FILE}; "
                "a crash mid-export leaves the metadata unwritten - "
                "re-export)")
        with open(meta_path, "r", encoding="utf-8") as f:
            meta = json.load(f)
        if meta.get("format") != ARTIFACT_FORMAT:
            raise ArtifactError(
                f"{path}: unrecognized artifact format "
                f"{meta.get('format')!r} (expected {ARTIFACT_FORMAT!r})")
        if meta.get("version") != ARTIFACT_VERSION:
            raise ArtifactVersionError(
                f"{path}: artifact format v{meta.get('version')} != "
                f"v{ARTIFACT_VERSION} supported by this library - "
                "re-export the artifact")
        g, P = int(meta["g"]), int(meta["P"])
        n_pairs = _num_pairs(g)
        with np.load(os.path.join(path, MAPS_FILE)) as z:
            mean_scale = np.ascontiguousarray(z["mean_scale"], np.float32)
            sd_scale = (np.ascontiguousarray(z["sd_scale"], np.float32)
                        if "sd_scale" in z.files else None)
            col_scale = np.ascontiguousarray(z["col_scale"], np.float32)
            col_mean = np.ascontiguousarray(z["col_mean"], np.float32)
            perm = np.ascontiguousarray(z["perm"], np.int64)
            inv_perm = np.ascontiguousarray(z["inv_perm"], np.int64)
            kept_cols = np.ascontiguousarray(z["kept_cols"], np.int64)
        if mean_scale.shape != (n_pairs,):
            raise ArtifactError(
                f"{path}: mean_scale shape {mean_scale.shape} != "
                f"({n_pairs},) for g={g}")
        mean_panels = cls._open_panels(path, MEAN_PANELS_FILE, n_pairs, P)
        has_sd = bool(meta.get("has_sd"))
        sd_panels = (cls._open_panels(path, SD_PANELS_FILE, n_pairs, P)
                     if has_sd else None)
        if has_sd and (sd_scale is None or sd_scale.shape != (n_pairs,)):
            raise ArtifactError(f"{path}: has_sd but sd_scale missing or "
                                "mis-shaped in maps.npz")
        p_original = int(meta["p_original"])
        n_pad = int(meta["n_pad"])
        zero_cols = np.setdiff1d(np.arange(p_original, dtype=np.int64),
                                 kept_cols)
        pre = PreprocessResult(
            data=np.empty((g, 0, P), np.float32),   # shape-only
            perm=perm, inv_perm=inv_perm,
            col_mean=col_mean, col_scale=col_scale,
            kept_cols=kept_cols, zero_cols=zero_cols,
            n_pad=n_pad, p_original=p_original)
        panel_crc = {}
        for kind, crcs in (meta.get("panel_crc") or {}).items():
            crcs = np.asarray(crcs, np.int64)
            if crcs.shape != (n_pairs,):
                raise ArtifactError(
                    f"{path}: panel_crc[{kind!r}] has {crcs.shape} entries"
                    f" != n_pairs {n_pairs}")
            panel_crc[kind] = crcs
        return cls(path=path, meta=meta, g=g, P=P, n_pairs=n_pairs,
                   p_original=p_original, n_pad=n_pad, has_sd=has_sd,
                   mean_panels=mean_panels, mean_scale=mean_scale,
                   sd_panels=sd_panels, sd_scale=sd_scale, pre=pre,
                   panel_crc=panel_crc)

    @staticmethod
    def _open_panels(path: str, name: str, n_pairs: int, P: int):
        fp = os.path.join(path, name)
        if not os.path.exists(fp):
            raise ArtifactError(f"{path}: missing panel file {name}")
        want = n_pairs * P * P
        have = os.path.getsize(fp)
        if have != want:
            raise ArtifactError(
                f"{path}/{name}: {have} bytes != expected {want} "
                f"(n_pairs={n_pairs}, P={P}) - truncated or mismatched "
                "artifact")
        return np.memmap(fp, dtype=np.int8, mode="r",
                         shape=(n_pairs, P, P))

    def verify_panel(self, kind: str, pair: int,
                     data: Optional[np.ndarray] = None) -> None:
        """Check one panel's bytes - the memmapped ones, or ``data``, a
        copy of them the caller goes on to use - against the CRC32
        recorded at export (a no-op without recorded CRCs); raises
        :class:`ArtifactCorruptError` on a mismatch."""
        crcs = self.panel_crc.get(kind)
        if crcs is None:
            return
        if data is None:
            data = self.panels(kind)[0][pair]
        got = panel_crc32(data)
        if got != int(crcs[pair]):
            raise ArtifactCorruptError(
                f"{self.path}: {kind} panel {pair} fails its CRC32 "
                f"(stored {int(crcs[pair]):#010x}, computed {got:#010x}) - "
                "the artifact bytes on disk are corrupt; re-export it or "
                "re-sync the replica", panel=pair, kind=kind)

    def panels(self, kind: str) -> tuple[np.ndarray, np.ndarray]:
        """(panels memmap, per-panel scales) for ``kind`` in mean|sd."""
        if kind == "mean":
            return self.mean_panels, self.mean_scale
        if kind == "sd":
            if self.sd_panels is None:
                raise ArtifactError(
                    "artifact has no posterior-SD panels (export a fit run "
                    "with ModelConfig(posterior_sd=True))")
            return self.sd_panels, self.sd_scale
        raise ValueError(f"unknown panel kind {kind!r} (mean | sd)")

    def assemble(self, *, kind: str = "mean", destandardize: bool = True,
                 reinsert_zero_cols: bool = True) -> np.ndarray:
        """Offline assembly of the dense matrix from the int8 panels (the
        native pass, or the NumPy path in its order: the same bits) - the
        Sigma a quant8 fit of the same panels returns."""
        q, s = self.panels(kind)
        return assemble_from_q8(np.ascontiguousarray(q), s, self.pre,
                                destandardize=destandardize,
                                reinsert_zero_cols=reinsert_zero_cols)


def _write_panels(path: str, name: str, q: np.ndarray) -> None:
    with open(os.path.join(path, name), "wb") as f:
        np.ascontiguousarray(q, np.int8).tofile(f)


def _build_maps(pre: PreprocessResult, mean_scale, sd_scale) -> dict:
    """The maps.npz payload, the same for every export path."""
    maps = dict(
        mean_scale=np.asarray(mean_scale, np.float32),
        col_scale=np.asarray(pre.col_scale, np.float32),
        col_mean=np.asarray(pre.col_mean, np.float32),
        perm=np.asarray(pre.perm, np.int64),
        inv_perm=np.asarray(pre.inv_perm, np.int64),
        kept_cols=np.asarray(pre.kept_cols, np.int64),
    )
    if sd_scale is not None:
        maps["sd_scale"] = np.asarray(sd_scale, np.float32)
    return maps


def _write_meta_last(path: str, meta: dict) -> None:
    """meta.json is written LAST and atomically: every partially-written
    artifact state is unopenable, never garbage behind healthy
    metadata."""
    tmp = os.path.join(path, META_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(path, META_FILE))


def _meta(pre: PreprocessResult, P: int, crc: dict, has_sd: bool,
          provenance: Optional[dict]) -> dict:
    meta = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "g": int(pre.num_shards),
        "P": int(P),
        "p_original": int(pre.p_original),
        "n_pad": int(pre.n_pad),
        "has_sd": bool(has_sd),
        "panel_crc": crc,
        "provenance": provenance or {},
    }
    meta["fingerprint"] = artifact_fingerprint(meta)
    return meta


def begin_streamed_artifact(path: str, *, g: int, P: int,
                            has_sd: bool = False):
    """The panel files of a streamed export as writable memmaps: the
    landing buffers of the streamed fetch (runtime/pipeline.
    StreamingFetcher).  An existing ``meta.json`` is removed first, so a
    crash mid-stream leaves a directory that refuses to open.  Each panel
    file is a fresh inode (an existing one is unlinked, never truncated:
    an earlier result may still map it).  Returns ``(mean memmap, SD
    memmap or None)``."""
    n_pairs = _num_pairs(g)
    os.makedirs(path, exist_ok=True)
    for name in (META_FILE, SD_PANELS_FILE, MEAN_PANELS_FILE):
        fp = os.path.join(path, name)
        if os.path.exists(fp):
            os.unlink(fp)
    mean_mm = np.memmap(os.path.join(path, MEAN_PANELS_FILE), dtype=np.int8,
                        mode="w+", shape=(n_pairs, P, P))
    sd_mm = (np.memmap(os.path.join(path, SD_PANELS_FILE), dtype=np.int8,
                       mode="w+", shape=(n_pairs, P, P)) if has_sd else None)
    return mean_mm, sd_mm


def finalize_streamed_artifact(
    path: str,
    *,
    mean_mm: np.ndarray,
    mean_scale: np.ndarray,
    pre: PreprocessResult,
    sd_mm: Optional[np.ndarray] = None,
    sd_scale: Optional[np.ndarray] = None,
    provenance: Optional[dict] = None,
) -> PosteriorArtifact:
    """Complete a streamed export: flush the landed memmaps, record their
    per-panel CRC32s, write the maps and the metadata (last) - the bytes a
    post-hoc :func:`export_fit_result` of the same chain writes - and
    return the artifact opened (read-only maps)."""
    n_pairs, P, _ = np.shape(mean_mm)
    g = pre.num_shards
    if n_pairs != _num_pairs(g) or g * P != pre.p_used:
        raise ValueError(
            f"streamed panels {np.shape(mean_mm)} do not match g={g}, "
            f"p_used={pre.p_used}")
    if np.shape(mean_scale) != (n_pairs,):
        raise ValueError(f"mean_scale must be ({n_pairs},), got "
                         f"{np.shape(mean_scale)}")
    if (sd_mm is None) != (sd_scale is None):
        raise ValueError("sd_mm and sd_scale must be passed together")
    mean_mm.flush()
    crc = {"mean": [int(panel_crc32(q)) for q in mean_mm]}
    if sd_mm is not None:
        sd_mm.flush()
        crc["sd"] = [int(panel_crc32(q)) for q in sd_mm]
    np.savez(os.path.join(path, MAPS_FILE),
             **_build_maps(pre, mean_scale, sd_scale))
    meta = _meta(pre, P, crc, sd_mm is not None, provenance)
    _write_meta_last(path, meta)
    record("artifact_write", path=os.path.basename(path), source="stream",
           fingerprint=meta["fingerprint"])
    return PosteriorArtifact.open(path)


def write_artifact(
    path: str,
    *,
    mean_q8: np.ndarray,
    mean_scale: np.ndarray,
    pre: PreprocessResult,
    sd_q8: Optional[np.ndarray] = None,
    sd_scale: Optional[np.ndarray] = None,
    provenance: Optional[dict] = None,
) -> PosteriorArtifact:
    """Write a v1 artifact directory from already-quantized mean panels
    (and SD panels, ``has_sd``) and return it opened.  An existing
    ``meta.json`` is removed before any payload byte lands and the new one
    written last."""
    n_pairs, P, P2 = np.shape(mean_q8)
    g = pre.num_shards
    if P != P2 or n_pairs != _num_pairs(g):
        raise ValueError(
            f"mean panels {np.shape(mean_q8)} are not the full "
            f"g(g+1)/2={_num_pairs(g)} upper-triangle set for g={g}")
    if g * P != pre.p_used:
        raise ValueError(f"g={g} panels of width {P} != p_used {pre.p_used}")
    if np.shape(mean_scale) != (n_pairs,):
        raise ValueError(f"mean_scale must be ({n_pairs},), got "
                         f"{np.shape(mean_scale)}")
    if (sd_q8 is None) != (sd_scale is None):
        raise ValueError("sd_q8 and sd_scale must be passed together")
    if sd_q8 is not None and np.shape(sd_q8) != (n_pairs, P, P):
        raise ValueError(f"sd panels {np.shape(sd_q8)} != mean panels "
                         f"({n_pairs}, {P}, {P})")
    os.makedirs(path, exist_ok=True)
    # chaos seam (resilience/faults.py, target "artifact"): failing or
    # delayed I/O before any byte lands, bit-flips AFTER the per-panel
    # CRCs are computed (the corruption lazy verification catches), a
    # torn panel file after the write
    plan = fault_plan()
    count = plan.on_write("artifact", path) if plan else 0
    crc = {"mean": [int(panel_crc32(q)) for q in np.asarray(mean_q8)]}
    if sd_q8 is not None:
        crc["sd"] = [int(panel_crc32(q)) for q in np.asarray(sd_q8)]
    if plan:
        payload = {MEAN_PANELS_FILE: mean_q8}
        if sd_q8 is not None:
            payload[SD_PANELS_FILE] = sd_q8
        mutated = plan.mutate_payload("artifact", path, count, payload)
        mean_q8 = mutated[MEAN_PANELS_FILE]
        sd_q8 = mutated.get(SD_PANELS_FILE, sd_q8)
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        os.unlink(meta_path)
    if sd_q8 is None and os.path.exists(os.path.join(path, SD_PANELS_FILE)):
        os.unlink(os.path.join(path, SD_PANELS_FILE))   # stale SD panels
    _write_panels(path, MEAN_PANELS_FILE, mean_q8)
    if plan:
        plan.after_replace("artifact", os.path.join(path, MEAN_PANELS_FILE),
                           count)
    if sd_q8 is not None:
        _write_panels(path, SD_PANELS_FILE, sd_q8)
    np.savez(os.path.join(path, MAPS_FILE),
             **_build_maps(pre, mean_scale, sd_scale))
    meta = _meta(pre, P, crc, sd_q8 is not None, provenance)
    _write_meta_last(path, meta)
    record("artifact_write", path=os.path.basename(path), source="export",
           fingerprint=meta["fingerprint"])
    return PosteriorArtifact.open(path)


def create_sparse_artifact(path: str, *, g: int, P: int,
                           has_sd: bool = False) -> str:
    """Synthesize an artifact with ZERO-filled sparse panel files.

    The panel files are created with ``truncate`` (filesystem holes), so a
    p=50k-scale artifact costs kilobytes of disk and opens in milliseconds
    - for serving capacity tests; real panel bytes can be patched in
    afterwards with ``np.memmap(mode='r+')`` (the meta records no panel
    CRCs, so the engine serves them unverified).  Scales are 1, the maps
    the identity, standardization none."""
    n_pairs = _num_pairs(g)
    p_used = g * P
    os.makedirs(path, exist_ok=True)
    names = [MEAN_PANELS_FILE] + ([SD_PANELS_FILE] if has_sd else [])
    for name in names:
        with open(os.path.join(path, name), "wb") as f:
            f.truncate(n_pairs * P * P)
    maps = dict(
        mean_scale=np.ones(n_pairs, np.float32),
        col_scale=np.ones((g, P), np.float32),
        col_mean=np.zeros((g, P), np.float32),
        perm=np.arange(p_used, dtype=np.int64),
        inv_perm=np.arange(p_used, dtype=np.int64),
        kept_cols=np.arange(p_used, dtype=np.int64),
    )
    if has_sd:
        maps["sd_scale"] = np.ones(n_pairs, np.float32)
    np.savez(os.path.join(path, MAPS_FILE), **maps)
    meta = {
        "format": ARTIFACT_FORMAT, "version": ARTIFACT_VERSION,
        "g": int(g), "P": int(P), "p_original": int(p_used), "n_pad": 0,
        "has_sd": bool(has_sd), "provenance": {"source": "synthesized"},
    }
    meta["fingerprint"] = artifact_fingerprint(meta)
    with open(os.path.join(path, META_FILE), "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    return path


def export_fit_result(res, path: str) -> PosteriorArtifact:
    """Export a :class:`dcfm_tpu_torch.api.FitResult` - no refit, no dense
    Sigma.  Under the quant8 fetch the fetched int8 panels and scales are
    written as they are; every other fetch is quantized on the host with
    the identical rule.  The SD panels ride along under posterior_sd."""
    if res._q8_panels is not None:
        mean_q8 = np.asarray(res._q8_panels)
        mean_scale = np.asarray(res._q8_scales, np.float32)
    else:
        mean_q8, mean_scale = quantize_panels(res.upper_panels)
    sd_q8 = sd_scale = None
    if res._sd_q8_panels is not None:
        sd_q8 = np.asarray(res._sd_q8_panels)
        sd_scale = np.asarray(res._sd_q8_scales, np.float32)
    elif res.sd_upper_panels is not None:
        sd_q8, sd_scale = quantize_panels(res.sd_upper_panels)
    return write_artifact(path, mean_q8=mean_q8, mean_scale=mean_scale,
                          pre=res.preprocess, sd_q8=sd_q8,
                          sd_scale=sd_scale,
                          provenance=fit_provenance(res.config, "fit"))


def fit_provenance(cfg: FitConfig, source: str) -> dict:
    """The provenance of an artifact exported from a fit (``source``
    "fit", or "fit-stream" for the streamed export)."""
    m, run = cfg.model, cfg.run
    return {"source": source, "num_shards": m.num_shards,
            "factors_per_shard": m.factors_per_shard, "prior": m.prior,
            "estimator": m.estimator, "seed": run.seed,
            "total_iters": run.total_iters}


def _exportable(cfg: FitConfig, n: int, p: int) -> None:
    """Refuse a checkpoint whose config the port cannot represent, naming
    the knob's Queue A item: the checks and refusals of a fit of the
    file's model, schedule and backend (``config.validate``).  What only
    steered the run that wrote the file (resume, cadence, stream_artifact,
    warm_start) is not the export's business."""
    validate(FitConfig(model=cfg.model, run=cfg.run, backend=cfg.backend,
                       permute=cfg.permute, standardize=cfg.standardize,
                       pad_to_shards=cfg.pad_to_shards), n, p)


def export_from_checkpoint(checkpoint_path: str, Y: np.ndarray,
                           path: str) -> PosteriorArtifact:
    """Export straight from a checkpoint - no refit, no random stream, so
    a file of either package (the port's, or the JAX package's of a config
    the port can represent).  Host NumPy throughout: the port of the JAX
    package's ``export_from_checkpoint``.

    ``Y`` (the original data matrix) is preprocessed again under the
    file's config and its ``data_fingerprint`` verified before anything is
    written.  A light file is read through its ``.full`` sidecar, or
    refused; a window with no saved draws is refused.  The mean panels are
    the chain mean of the sums times ``inv_count`` in the JAX package's
    NumPy order (``acc.mean(axis=0)[:n_pairs] * inv_count``), quantized
    with the quant8 rule; the SD panels (a file with ``sigma_sq_acc``) are
    ``sqrt(max(m2 - mean * mean, 0) * bessel)``.  The divisor is the
    window's (runtime/fetch.accumulator_window), with the file's elastic
    bookkeeping (meta v7) when it holds any.  A ``store_draws`` file's
    draw ring is sized from the file's schedule and skipped, and an
    imputation file's ``y_imp_acc`` (its last leaf) is not read: neither
    enters the panels.  ``.procK-of-N`` sets are refused (ROADMAP Queue A
    item 7)."""
    refuse_multiprocess_sets(checkpoint_path)
    if not os.path.exists(checkpoint_path):
        raise FileNotFoundError(f"no checkpoint at {checkpoint_path}")
    meta = read_checkpoint_meta(checkpoint_path)
    if meta.get("state_only"):
        side = checkpoint_path + ".full"
        # only an absent sidecar is the refusal below: a corrupt one
        # raises its own read error
        smeta = (read_checkpoint_meta(side) if os.path.exists(side)
                 else {"state_only": True})
        if smeta.get("state_only"):
            raise ArtifactError(
                f"{checkpoint_path} is a state-only (light) checkpoint: it "
                "stores no covariance accumulators and no .full sidecar "
                "exists - export from a full checkpoint "
                "(checkpoint_mode='full' or checkpoint_full_every)")
        checkpoint_path, meta = side, smeta
    cfg = config_from_checkpoint_meta(meta)
    Y = np.asarray(Y)
    _exportable(cfg, *Y.shape)
    m, run = cfg.model, cfg.run
    pre = preprocess(Y, m.num_shards, permute=cfg.permute,
                     standardize=cfg.standardize,
                     pad_to_shards=cfg.pad_to_shards, seed=run.seed)
    if meta["fingerprint"] != data_fingerprint(pre.data):
        raise ArtifactError(
            "checkpoint data fingerprint mismatch - the data matrix passed "
            "to export is not the one the checkpointed chain ran on")
    C = run.num_chains
    leaves, meta = load_checkpoint(checkpoint_path, carry_template(
        m, n=pre.data.shape[1], P=pre.data.shape[2], num_chains=C,
        num_stored_draws=run.num_saved if run.store_draws else 0))
    it = int(meta["iteration"])
    acc0 = int(meta.get("acc_start", 0))
    starts, fold, _ = elastic_meta(meta, C)
    uniform = not fold and len(set(starts)) <= 1
    n_saved, inv_count, bessel = accumulator_window(
        it, run.burnin, run.thin, acc0, C,
        chain_acc_starts=None if uniform else starts,
        fold_draws=0 if uniform else fold)
    if n_saved <= 0 and not fold:
        raise ArtifactError(
            f"checkpoint at iteration {it} has no saved draws in its "
            "accumulation window - nothing to export (burn-in only, or a "
            "light resume restarted the window)")
    n_pairs = num_upper_pairs(m.num_shards)

    def mean_panels(acc):
        acc = np.asarray(acc, np.float32)
        if C > 1:
            acc = acc.mean(axis=0)
        return acc[:n_pairs] * inv_count

    mean = mean_panels(leaves["sigma_acc"])
    mean_q8, mean_scale = quantize_panels(mean)
    sd_q8 = sd_scale = None
    if "sigma_sq_acc" in leaves:
        m2 = mean_panels(leaves["sigma_sq_acc"])
        sd = np.sqrt(np.maximum(m2 - mean * mean, np.float32(0.0))
                     * bessel)
        sd_q8, sd_scale = quantize_panels(sd)
    provenance = {
        "source": "checkpoint",
        "checkpoint": os.path.abspath(checkpoint_path),
        "iteration": it,
        "n_saved": int(n_saved),
        "num_chains": C,
        "num_shards": m.num_shards,
        "factors_per_shard": m.factors_per_shard,
        "prior": m.prior,
        "estimator": m.estimator,
        "seed": run.seed,
    }
    return write_artifact(path, mean_q8=mean_q8, mean_scale=mean_scale,
                          pre=pre, sd_q8=sd_q8, sd_scale=sd_scale,
                          provenance=provenance)


def export_main(args) -> int:
    """The CLI's ``export`` (an argparse Namespace from cli.py): from a
    checkpoint (no refit), or a quant8 fit on ``args.device`` exported
    whole.  Prints one JSON line."""
    from dcfm_tpu_torch.cli import _load
    Y = _load(args.data)
    if args.from_checkpoint:
        art = export_from_checkpoint(args.from_checkpoint, Y, args.out)
    else:
        if not args.shards or not args.factors:
            raise SystemExit(
                "export without --from-checkpoint runs a fit: --shards and "
                "--factors are required")
        if args.factors % args.shards:
            raise SystemExit(
                f"--factors {args.factors} must be divisible by --shards "
                f"{args.shards}")
        from dcfm_tpu_torch.api import fit
        from dcfm_tpu_torch.config import (
            BackendConfig, ModelConfig, RunConfig)
        cfg = FitConfig(
            model=ModelConfig(
                num_shards=args.shards,
                factors_per_shard=args.factors // args.shards,
                rho=args.rho, prior=args.prior,
                posterior_sd=args.posterior_sd),
            run=RunConfig(burnin=args.burnin, mcmc=args.mcmc,
                          thin=args.thin, seed=args.seed),
            backend=BackendConfig(fetch_dtype="quant8"),
        )
        art = export_fit_result(fit(Y, cfg, device=args.device), args.out)
    size = sum(
        os.path.getsize(os.path.join(args.out, f))
        for f in os.listdir(args.out))
    print(json.dumps({  # dcfm: ignore[DCFM901] - the export CLI's stdout JSON protocol
        "out": args.out, "g": art.g, "P": art.P, "p": art.p_original,
        "has_sd": art.has_sd, "bytes": int(size),
        "source": art.meta["provenance"].get("source"),
    }))
    return 0
