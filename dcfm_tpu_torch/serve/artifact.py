"""Durable, memory-mapped posterior artifact: fit once, serve forever.

The port's copy of the NumPy/stdlib part of ``dcfm_tpu/serve/artifact.py``,
in the same format (``dcfm-posterior-artifact`` v1): an artifact exported
here opens under the JAX package's ``PosteriorArtifact`` and the other way
round (its posterior-SD panels, ``sd_q8.bin``, included; the port writes
none).  A directory::

    artifact/
      mean_q8.bin   int8  (n_pairs, P, P) C-order  - memmapped
      maps.npz      per-panel scales + preprocess maps (O(p), loaded whole)
      meta.json     format tag, version, shape, per-panel CRC32s,
                    provenance, fingerprint - written LAST

The panels are the packed g(g+1)/2 upper-triangle panels in the canonical
triu order the device accumulates and the native assembler consumes,
quantized with the quant8 link's max-abs rule (runtime/fetch.cast_for_link;
:func:`quantize_panels` is its host twin).  ``meta.json`` is removed first
and written last, so a half-written artifact fails to open instead of
serving garbage.

Not ported (ROADMAP Queue A): writing posterior-SD panels (item 5), the
streamed and cooperative exports, ``export_from_checkpoint`` (item 3) and
the fault-injection and flight-recorder seams, the query engine and the
server (item 7).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import zlib
from typing import Optional

import numpy as np

from dcfm_tpu_torch.utils.estimate import assemble_from_q8
from dcfm_tpu_torch.utils.preprocess import PreprocessResult

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

    def verify_panel(self, kind: str, pair: int) -> None:
        """Check one panel's bytes against the CRC32 recorded at export
        (a no-op without recorded CRCs); raises
        :class:`ArtifactCorruptError` on a mismatch."""
        crcs = self.panel_crc.get(kind)
        if crcs is None:
            return
        raw, _ = self.panels(kind)
        got = panel_crc32(raw[pair])
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


def _build_maps(pre: PreprocessResult, mean_scale) -> dict:
    """The maps.npz payload."""
    return dict(
        mean_scale=np.asarray(mean_scale, np.float32),
        col_scale=np.asarray(pre.col_scale, np.float32),
        col_mean=np.asarray(pre.col_mean, np.float32),
        perm=np.asarray(pre.perm, np.int64),
        inv_perm=np.asarray(pre.inv_perm, np.int64),
        kept_cols=np.asarray(pre.kept_cols, np.int64),
    )


def _write_meta_last(path: str, meta: dict) -> None:
    """meta.json is written LAST and atomically: every partially-written
    artifact state is unopenable, never garbage behind healthy
    metadata."""
    tmp = os.path.join(path, META_FILE + ".tmp")
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(meta, f, indent=1)
    os.replace(tmp, os.path.join(path, META_FILE))


def write_artifact(
    path: str,
    *,
    mean_q8: np.ndarray,
    mean_scale: np.ndarray,
    pre: PreprocessResult,
    provenance: Optional[dict] = None,
) -> PosteriorArtifact:
    """Write a v1 artifact directory from already-quantized mean panels
    and return it opened.  An existing ``meta.json`` is removed before any
    payload byte lands and the new one written last."""
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
    os.makedirs(path, exist_ok=True)
    crc = {"mean": [int(panel_crc32(q)) for q in np.asarray(mean_q8)]}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        os.unlink(meta_path)
    if os.path.exists(os.path.join(path, SD_PANELS_FILE)):
        os.unlink(os.path.join(path, SD_PANELS_FILE))   # stale SD panels
    _write_panels(path, MEAN_PANELS_FILE, mean_q8)
    np.savez(os.path.join(path, MAPS_FILE), **_build_maps(pre, mean_scale))
    meta = {
        "format": ARTIFACT_FORMAT,
        "version": ARTIFACT_VERSION,
        "g": int(g),
        "P": int(P),
        "p_original": int(pre.p_original),
        "n_pad": int(pre.n_pad),
        "has_sd": False,
        "panel_crc": crc,
        "provenance": provenance or {},
    }
    meta["fingerprint"] = artifact_fingerprint(meta)
    _write_meta_last(path, meta)
    return PosteriorArtifact.open(path)


def export_fit_result(res, path: str) -> PosteriorArtifact:
    """Export a :class:`dcfm_tpu_torch.api.FitResult` - no refit, no dense
    Sigma.  Under the quant8 fetch the fetched int8 panels and scales are
    written as they are; every other fetch is quantized on the host with
    the identical rule."""
    if res._q8_panels is not None:
        mean_q8 = np.asarray(res._q8_panels)
        mean_scale = np.asarray(res._q8_scales, np.float32)
    else:
        mean_q8, mean_scale = quantize_panels(res.upper_panels)
    m, run = res.config.model, res.config.run
    provenance = {
        "source": "fit",
        "num_shards": m.num_shards,
        "factors_per_shard": m.factors_per_shard,
        "prior": m.prior,
        "estimator": m.estimator,
        "seed": run.seed,
        "total_iters": run.total_iters,
    }
    return write_artifact(path, mean_q8=mean_q8, mean_scale=mean_scale,
                          pre=res.preprocess, provenance=provenance)
