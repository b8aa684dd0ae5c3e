"""Concurrent posterior query engine over a memory-mapped artifact, on the
card.

The port of ``dcfm_tpu/serve/engine.py``.  Where the JAX engine
dequantizes panels into host memory, this one keeps its byte-budgeted LRU
of dequantized float32 panels in the device's memory (``device``: the
card unless the caller asks for the CPU, as the tests do): a cache miss
checks the panel's CRC on the host, copies its int8 bytes to the device
and dequantizes there; a query gathers on the device and copies its
answer to the host once.  Entry / block / row queries, posterior SD and
normal-approximation intervals never materialize the dense (p, p)
matrix.

Bitwise contract: every value equals, bit for bit, the JAX engine's and
the offline assembly's (``PosteriorArtifact.assemble``), because each
step is one correctly rounded float32 elementwise operation in the JAX
engine's order, with no fusion and no reassociation (no
``torch.compile``, no TF32 - nothing here multiplies matrices):

1. dequantize: ``v = float32(q) * factor[pair]`` with ``factor =
   float32(panel_scale) / 127.0`` computed once in NumPy, as the JAX
   engine computes it, and copied to the device;
2. diagonal-pair panels are symmetrized ``0.5 * (B + B')``;
3. de-standardize: ``v * (s[row] * s[col])`` - the two column scales
   first, then one multiply.

Queries take caller-coordinate column indices (``FitResult.Sigma``'s, zero
columns reinserted): entries in a dropped all-zero column are exactly 0.
Answers are the JAX engine's types: ``np.float32`` scalars and float32
ndarrays.  Thread-safe: the panel cache takes a lock; many handler
threads may query one engine, each answer's copy to the host is its only
synchronization with the device.
"""

from __future__ import annotations

import collections
import math
import threading

import numpy as np
import torch

from dcfm_tpu_torch.resilience.faults import fault_plan
from dcfm_tpu_torch.serve.artifact import PosteriorArtifact
from dcfm_tpu_torch.utils.preprocess import caller_to_shard_index


def resolve_device(device) -> torch.device:
    """``None`` -> the card; a card that is asked for and absent raises
    (there is no fallback to the CPU)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the query engine runs on the card by default, and "
            "torch.cuda.is_available() is false (there is no fallback to "
            "the CPU: pass device='cpu' to serve from host memory)")
    return device


def device_label(device: torch.device) -> str:
    """``"cpu"``, or the card's index and name: ``"cuda:0 (NVIDIA H100
    80GB HBM3)"`` - the ``device`` the server reports."""
    if device.type != "cuda":
        return str(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return f"cuda:{index} ({torch.cuda.get_device_name(index)})"


def _nbytes(panel: torch.Tensor) -> int:
    return panel.numel() * panel.element_size()


class PanelCache:
    """Byte-budgeted LRU over dequantized float32 panels (device tensors).

    Keys are ``(kind, pair_index)``; values are the ready-to-serve float32
    panels (diagonal pairs already symmetrized).  The budget and
    ``stats()["bytes"]`` count device bytes; eviction is LRU by footprint,
    and the hit/miss/eviction counters are exported on /metrics."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._od: "collections.OrderedDict" = collections.OrderedDict()
        self._bytes = 0
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # per-key touch counts, surviving eviction: the hot set the
        # pre-warmer replays into the next generation's engine
        self._touch: "collections.Counter" = collections.Counter()

    def get(self, key, make):
        with self._lock:
            self._touch[key] += 1
            panel = self._od.get(key)
            if panel is not None:
                self.hits += 1
                self._od.move_to_end(key)
                return panel
            self.misses += 1
        # dequantize OUTSIDE the lock: misses on different panels must not
        # serialize; a racing double make of one panel is benign (the same
        # bytes; the insert below stays under the lock, the first wins)
        panel = make()
        with self._lock:
            if key not in self._od:
                self._od[key] = panel
                self._bytes += _nbytes(panel)
                while self._bytes > self.budget_bytes and len(self._od) > 1:
                    _, old = self._od.popitem(last=False)
                    self._bytes -= _nbytes(old)
                    self.evictions += 1
            else:
                self._od.move_to_end(key)
        return panel

    def seed(self, key, panel) -> None:
        """Insert a ready panel without touching the hit/miss counters -
        adoption carries dequantized panels across a hot swap."""
        with self._lock:
            if key in self._od:
                return
            self._od[key] = panel
            self._bytes += _nbytes(panel)
            while self._bytes > self.budget_bytes and len(self._od) > 1:
                _, old = self._od.popitem(last=False)
                self._bytes -= _nbytes(old)
                self.evictions += 1

    def snapshot(self) -> list:
        """One consistent ``[(key, panel), ...]`` view of the resident
        panels, LRU-coldest first."""
        with self._lock:
            return list(self._od.items())

    def stats(self) -> dict:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "panels": len(self._od),
                    "bytes": self._bytes,
                    "budget_bytes": self.budget_bytes}

    def hot_keys(self, limit: int) -> list:
        """The ``limit`` most-touched keys, hottest first (evicted keys
        included)."""
        with self._lock:
            return [k for k, _ in self._touch.most_common(int(limit))]


def _norm_ppf(p: float) -> float:
    """Standard normal inverse CDF (Acklam's rational approximation,
    |rel err| < 1.2e-9), on the host."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return ((((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4])
                 * q + c[5])
                / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1))
    if p > phigh:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return ((((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4])
             * r + a[5]) * q
            / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4])
               * r + 1))


# panels stacked for one gather: 256 of the north-star width's 157^2
# float32 panels are 25 MB of device memory, config 5's 196^2 39 MB
_STACK = 256


class QueryEngine:
    """Entry/block/row/SD/interval queries over one opened artifact."""

    def __init__(self, artifact: PosteriorArtifact, *,
                 cache_bytes: int = 256 << 20,
                 adopt_from: "QueryEngine" = None, device=None):
        self.device = resolve_device(device)
        self.artifact = artifact
        self.cache = PanelCache(cache_bytes)
        g, P = artifact.g, artifact.P
        self._g, self._P = g, P
        # flattened shard-coordinate de-standardization scales (p_used,)
        s = np.ascontiguousarray(artifact.pre.col_scale,
                                 np.float32).reshape(-1)
        self._s = torch.from_numpy(s.copy()).to(self.device)
        # per-panel dequant factors, computed in NumPy as the JAX engine
        # computes them (float32 / 127.0), then copied to the device
        self._factor = {"mean": artifact.mean_scale / 127.0}
        if artifact.has_sd:
            self._factor["sd"] = artifact.sd_scale / 127.0
        self._factor_t = {
            k: torch.from_numpy(np.ascontiguousarray(v, np.float32).copy()
                                ).to(self.device)
            for k, v in self._factor.items()}
        # memmap adoption across a hot swap: pairs whose bytes AND scale
        # are unchanged from the predecessor serve from ITS memmaps (and
        # its device panels), so re-warm work scales with changed-and-hot
        self._adopt_src = None             # predecessor PosteriorArtifact
        self._adopted_raw = {}             # kind -> predecessor memmap
        self._adopted_pairs = {}           # kind -> frozenset of pairs
        self.panels_adopted = 0            # pairs adopted, summed over kinds
        self.cache_seeded = 0              # device panels carried over
        if adopt_from is not None:
            self._adopt(adopt_from)

    def _adopt(self, old: "QueryEngine") -> None:
        """Adopt the unchanged half of a predecessor engine: same (g, P,
        has_sd), the same device, complete CRC tables on both artifacts,
        and per pair an equal panel CRC AND a bitwise-equal dequant factor
        (a scale-only change alters served values without touching panel
        bytes).  Anything else falls through to the new artifact's own
        memmaps; correctness never depends on adoption."""
        art, prev = self.artifact, old.artifact
        if (art.g, art.P, art.has_sd) != (prev.g, prev.P, prev.has_sd):
            return
        if old.device != self.device:
            return
        kinds = ("mean", "sd") if art.has_sd else ("mean",)
        if not all(k in art.panel_crc and k in prev.panel_crc
                   for k in kinds):
            return
        for kind in kinds:
            same_crc = art.panel_crc[kind] == prev.panel_crc[kind]
            new_s = np.asarray(self._factor[kind], np.float32)
            old_s = np.asarray(old._factor[kind], np.float32)
            same_scale = new_s.view(np.int32) == old_s.view(np.int32)
            pairs = frozenset(
                int(i) for i in np.flatnonzero(same_crc & same_scale))
            if not pairs:
                continue
            self._adopted_pairs[kind] = pairs
            self._adopted_raw[kind], _ = prev.panels(kind)
            self.panels_adopted += len(pairs)
        if self.panels_adopted:
            self._adopt_src = prev
            # identical bytes * identical factor = identical float32 panel:
            # the predecessor's device panels restart the hot set warm
            for (kind, pair), panel in old.cache.snapshot():
                if pair in self._adopted_pairs.get(kind, ()):
                    self.cache.seed((kind, pair), panel)
                    self.cache_seeded += 1

    def panel_source(self, kind: str, pair: int) -> str:
        """``"adopted"`` when this (kind, pair) serves from the predecessor
        generation's memmap, else ``"new"``."""
        return ("adopted" if pair in self._adopted_pairs.get(kind, ())
                else "new")

    # -- coordinates ---------------------------------------------------
    def shard_index(self, idx) -> np.ndarray:
        """Caller columns -> shard positions (-1 = dropped zero column).
        Raises IndexError for out-of-range indices."""
        return caller_to_shard_index(self.artifact.pre, idx)

    def _pair(self, r: int, c: int) -> int:
        """Canonical triu panel index of shard-block (r, c), r <= c."""
        return r * self._g - (r * (r - 1)) // 2 + (c - r)

    # -- panels --------------------------------------------------------
    def _panel(self, kind: str, pair: int, diag: bool) -> torch.Tensor:
        """Dequantized float32 device panel via the LRU cache; diagonal
        pairs are stored symmetrized.

        Integrity is verified on the cache-miss path only: the panel's
        bytes are copied out of the read-only memmap and THAT copy is
        CRC-checked against the export-time ``panel_crc`` before it goes
        to the device, so a corrupt panel raises the typed
        ArtifactCorruptError on its first touch (and again after an
        eviction) and no byte that was not checked is ever served."""
        if pair in self._adopted_pairs.get(kind, ()):
            # unchanged pair: the predecessor generation's memmap (the
            # same bytes, pinned by CRC) - the new panel file stays cold
            raw, src = self._adopted_raw[kind], self._adopt_src
        else:
            raw, src = self.artifact.panels(kind)[0], self.artifact
        factor = self._factor_t[kind][pair]

        def make():
            # chaos seam: the serve-side io fault point is the cache-miss
            # dequant (io_delay stalls it, io_error raises OSError the
            # HTTP layer maps to a typed retryable 503)
            plan = fault_plan()
            if plan is not None:
                plan.on_write("panel", f"{kind}:{pair}")
            host = np.array(raw[pair])          # a writable copy
            src.verify_panel(kind, pair, host)
            q = torch.from_numpy(host).to(self.device)
            p = q.to(torch.float32) * factor
            if diag:
                p = 0.5 * (p + p.T)
            return p

        return self.cache.get((kind, pair), make)

    # -- queries -------------------------------------------------------
    def entry(self, i: int, j: int, *, kind: str = "mean",
              destandardize: bool = True) -> np.float32:
        """Posterior mean (or SD) of Sigma[i, j], caller coordinates."""
        si, sj = (int(v) for v in self.shard_index([i, j]))
        if si < 0 or sj < 0:
            return np.float32(0.0)      # dropped all-zero column
        P = self._P
        r, a = divmod(si, P)
        c, b = divmod(sj, P)
        if r > c:
            r, c, a, b = c, r, b, a
        v = self._panel(kind, self._pair(r, c), r == c)[a, b]
        if destandardize:
            v = v * (self._s[si] * self._s[sj])
        return np.float32(v.item())

    def _gather(self, kind: str, pairs: list, slot: np.ndarray,
                a: np.ndarray, b: np.ndarray) -> torch.Tensor:
        """Entry ``n`` of the result is ``panel[a[n], b[n]]`` of the panel
        of shard block ``pairs[slot[n]]`` (r <= c), on the device.  The
        panels are touched in ``pairs`` order (the JAX engine's order, so
        the same LRU counters), stacked _STACK at a time and read with one
        gather per stack: a constant number of device operations per
        query, whatever the number of panels it spans."""
        P2 = self._P * self._P
        flat = slot * P2 + a * self._P + b
        out = None
        for g0 in range(0, len(pairs), _STACK):
            stack = torch.stack([
                self._panel(kind, self._pair(r, c), r == c)
                for r, c in pairs[g0:g0 + _STACK]]).view(-1)
            if len(pairs) <= _STACK:
                return stack[torch.from_numpy(flat).to(self.device)]
            if out is None:
                out = torch.empty(flat.size, dtype=torch.float32,
                                  device=self.device)
            sel = np.flatnonzero((slot >= g0) & (slot < g0 + _STACK))
            out[torch.from_numpy(sel).to(self.device)] = stack[
                torch.from_numpy(flat[sel] - g0 * P2).to(self.device)]
        return out

    def entries(self, queries) -> list:
        """Batch of ``(i, j, destandardize)`` mean-entry queries, grouped
        by target panel: one cache access per panel in the order the batch
        first touches it (the JAX engine's), one device gather for the
        batch, the scales applied to the whole batch at once, and one copy
        to the host.  Returns float32 values in query order."""
        n = len(queries)
        ij = np.asarray([(q[0], q[1]) for q in queries], np.int64).reshape(
            -1, 2)
        dest = np.asarray([bool(q[2]) for q in queries], bool)
        sidx = self.shard_index(ij.reshape(-1)).reshape(-1, 2)
        live = np.flatnonzero((sidx >= 0).all(axis=1))
        if live.size == 0:
            return [np.float32(0.0)] * n
        si, sj = sidx[live, 0], sidx[live, 1]
        r, a = np.divmod(si, self._P)
        c, b = np.divmod(sj, self._P)
        swap = r > c
        r, c = np.where(swap, c, r), np.where(swap, r, c)
        a, b = np.where(swap, b, a), np.where(swap, a, b)
        keys, first, inv = np.unique(r * self._g + c, return_index=True,
                                     return_inverse=True)
        visit = np.argsort(first, kind="stable")     # first-touch order
        rank = np.empty_like(visit)
        rank[visit] = np.arange(visit.size)
        pairs = [divmod(int(k), self._g) for k in keys[visit]]
        vals = self._gather("mean", pairs, rank[inv.reshape(-1)], a, b)
        dev = self.device
        scaled = vals * (self._s[torch.from_numpy(si).to(dev)]
                         * self._s[torch.from_numpy(sj).to(dev)])
        want = torch.from_numpy(dest[live]).to(dev)
        vals = torch.where(want, scaled, vals).cpu().numpy()
        out = np.zeros(n, np.float32)
        out[live] = vals
        return [np.float32(v) for v in out]

    def block(self, rows, cols, *, kind: str = "mean",
              destandardize: bool = True) -> np.ndarray:
        """Sub-block Sigma[np.ix_(rows, cols)] in caller coordinates,
        touching only the panels the block intersects (in the JAX
        engine's order): gathered and scaled on the device, copied to the
        host once."""
        rows = np.atleast_1d(np.asarray(rows, np.int64))
        cols = np.atleast_1d(np.asarray(cols, np.int64))
        sr = self.shard_index(rows)
        sc = self.shard_index(cols)
        out = np.zeros((rows.size, cols.size), np.float32)
        vr, vc = np.flatnonzero(sr >= 0), np.flatnonzero(sc >= 0)
        if vr.size == 0 or vc.size == 0:
            return out
        P = self._P
        r_shard, r_loc = np.divmod(sr[vr], P)
        c_shard, c_loc = np.divmod(sc[vc], P)
        ur, ir = np.unique(r_shard, return_inverse=True)
        uc, ic = np.unique(c_shard, return_inverse=True)
        # the JAX engine's loop: every (row shard, col shard), row-major,
        # the panel of (min, max) - a pair met both ways is touched twice
        pairs = [(min(rs, cs), max(rs, cs)) for rs in ur.tolist()
                 for cs in uc.tolist()]
        below = (r_shard[:, None] <= c_shard[None, :])
        a = np.where(below, r_loc[:, None], c_loc[None, :])
        b = np.where(below, c_loc[None, :], r_loc[:, None])
        slot = ir.reshape(-1)[:, None] * uc.size + ic.reshape(-1)[None, :]
        vals = self._gather(kind, pairs, slot.reshape(-1), a.reshape(-1),
                            b.reshape(-1)).view(vr.size, vc.size)
        if destandardize:
            dev = self.device
            s_r = self._s[torch.from_numpy(sr[vr]).to(dev)]
            s_c = self._s[torch.from_numpy(sc[vc]).to(dev)]
            vals = vals * (s_r[:, None] * s_c[None, :])
        out[np.ix_(vr, vc)] = vals.cpu().numpy()
        return out

    def row(self, i: int, *, kind: str = "mean",
            destandardize: bool = True) -> np.ndarray:
        """Full row i of the posterior matrix, (p_original,)."""
        return self.block(
            [i], np.arange(self.artifact.p_original), kind=kind,
            destandardize=destandardize)[0]

    def sd_entry(self, i: int, j: int, *,
                 destandardize: bool = True) -> np.float32:
        return self.entry(i, j, kind="sd", destandardize=destandardize)

    def interval(self, i: int, j: int, *, alpha: float = 0.05,
                 destandardize: bool = True) -> tuple:
        """Normal-approximation equal-tailed (1-alpha) credible interval
        for Sigma[i, j]: mean +/- z_{1-alpha/2} * posterior SD, the
        quantile on the host.  Returns ``(mean, sd, lo, hi)`` floats."""
        mean = float(self.entry(i, j, destandardize=destandardize))
        sd = float(self.sd_entry(i, j, destandardize=destandardize))
        z = _norm_ppf(1.0 - alpha / 2.0)
        return mean, sd, mean - z * sd, mean + z * sd

    def stats(self) -> dict:
        return self.cache.stats()

    # -- hot-set pre-warming -------------------------------------------
    def hot_panels(self, limit: int = 64) -> list:
        """The hottest ``(kind, pair)`` keys by touch count, hottest
        first."""
        return self.cache.hot_keys(limit)

    def prewarm(self, keys) -> int:
        """Dequantize the given ``(kind, pair)`` keys into the cache
        (coldest first, so the hottest land at the LRU's warm end).
        Unknown kinds and out-of-range pairs are skipped.  Returns the
        number of panels now resident."""
        warmed = 0
        for kind, pair in reversed(list(keys)):
            kind, pair = str(kind), int(pair)
            if kind not in self._factor:
                continue
            raw, _ = self.artifact.panels(kind)
            if not 0 <= pair < raw.shape[0]:
                continue
            diag = any(self._pair(r, r) == pair for r in range(self._g))
            self._panel(kind, pair, diag)
            warmed += 1
        return warmed
