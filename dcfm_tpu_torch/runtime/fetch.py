"""Device->host fetch of the covariance accumulator, and the upload.

The port of the single-process, post-hoc part of
``dcfm_tpu/runtime/fetch.py``.  The accumulator is the biggest
device->host artifact of a fit (~p^2/2 floats); everything here exists to
move it cheaply:

* :func:`fetch_prep` - on the device, in torch ops: the chain mean, the
  padding trim and the division by the saved-draw count, in the float32
  arithmetic of the JAX package's fetch, then :func:`cast_for_link`;
* :func:`fetch_sd_prep` - the entrywise posterior SD (ModelConfig.
  posterior_sd) from the second-moment sums and the prepped mean, formed
  in float32 on the device before any link cast (the JAX package's
  ``fetch_sd_jit``);
* :func:`cast_for_link` - the down-cast for the link: bfloat16, float16,
  or quant8 (max-abs int8 per panel with one float32 scale);
* :class:`Drain` / :func:`quant8_start` / :func:`quant8_drain` /
  :func:`quant8_fetch_assemble` - the copy to the host: at most 8 slices,
  each an asynchronous copy into pinned host memory on one side stream
  followed by an event, waited slice by slice, and the native one-pass
  assembly of the caller-coordinate Sigma;
* :func:`upload_host_array` - the data's down-cast for the host->device
  link (the device casts back to float32 on arrival);
* :func:`accumulator_window` - the one home of the window divisor: the
  post-hoc fetch, the streamed fetch (runtime/pipeline.StreamingFetcher)
  and a light resume's restarted window all divide by what it returns.

On the CPU the same functions run with no stream and no pinned memory:
the "copy" is the tensor itself.  No fetch runs inside a captured graph.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from dcfm_tpu_torch.analysis.registry import TraceSpec, register_trace_entry
from dcfm_tpu_torch.models.sampler import num_saved_draws
from dcfm_tpu_torch.models.state import num_upper_pairs
from dcfm_tpu_torch.profiling import Phase
from dcfm_tpu_torch.utils.estimate import assemble_from_q8
from dcfm_tpu_torch.utils.preprocess import PreprocessResult

LINK_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "float16": torch.float16}


def elastic_pooled_draws(total_iters: int, burnin: int, thin: int,
                         chain_acc_starts, fold_draws: int = 0) -> int:
    """Total saved draws the pooled accumulators hold: each chain's own
    window ``(acc_start_c, total_iters]`` plus the draws folded in from
    dropped chains (``fold_draws``, checkpoint meta v7).  Integer-exact."""
    return fold_draws + sum(
        num_saved_draws(total_iters, burnin, thin)
        - num_saved_draws(int(a), burnin, thin)
        for a in chain_acc_starts)


def accumulator_window(total_iters: int, burnin: int, thin: int,
                       acc_start: int, num_chains: int,
                       chain_acc_starts=None, fold_draws: int = 0):
    """``(n_saved, inv_count, bessel)`` for the accumulator window
    ``(acc_start, total_iters]``: the divisor :func:`fetch_prep` scales
    by.  The streamed and the post-hoc fetch both call this, so the two
    feed fetch_prep the same float32 divisor (their bitwise equality
    depends on it); the arithmetic is the JAX package's
    ``runtime.fetch.accumulator_window``, non-elastic branch bit for bit.

    ``chain_acc_starts`` / ``fold_draws`` (checkpoint meta v7): per-chain
    window starts and draws folded in from dropped chains; fetch_prep
    computes ``sum over chains * inv_count / C``, so their inv_count is
    ``C / total_draws``.  The uniform case reduces to ``1 / n_saved``."""
    n_saved = (num_saved_draws(total_iters, burnin, thin)
               - num_saved_draws(acc_start, burnin, thin))
    if chain_acc_starts is None and not fold_draws:
        inv_count = np.float32(1.0 / max(n_saved, 1))
        n_draws = max(n_saved * num_chains, 1)
        bessel = np.float32(n_draws / (n_draws - 1) if n_draws > 1 else 1.0)
        return n_saved, inv_count, bessel
    if chain_acc_starts is None:
        chain_acc_starts = [acc_start] * num_chains
    total_draws = elastic_pooled_draws(total_iters, burnin, thin,
                                       chain_acc_starts, fold_draws)
    n_saved = max(n_saved, max(
        (num_saved_draws(total_iters, burnin, thin)
         - num_saved_draws(int(a), burnin, thin))
        for a in chain_acc_starts))
    inv_count = np.float32(num_chains / max(total_draws, 1))
    n_draws = max(total_draws, 1)
    bessel = np.float32(n_draws / (n_draws - 1) if n_draws > 1 else 1.0)
    return n_saved, inv_count, bessel


def _chain_factor(num_chains: int, inv_count) -> float:
    """``inv_count`` times the float32 1/num_chains, folded as XLA folds
    the chain mean's division into the scalar."""
    factor = np.float32(inv_count)
    if num_chains > 1:
        factor = factor * np.float32(1.0 / num_chains)
    return float(factor)


def fetch_prep(acc: torch.Tensor, num_chains: int, g: int, inv_count,
               mode: str, *, keep: Optional[int] = None):
    """The posterior-mean panels for the link, from ``acc``: the packed
    accumulators of the ``num_chains`` chains summed in chain order (the
    sum JAX's ``acc.mean(axis=0)`` reduces), which this CONSUMES - it is
    scaled in place.  ``keep``: the leading panels kept (default the
    g(g+1)/2 of g shards; a shard-mesh rank keeps all of its pair slice,
    parallel/shard.RankMesh.fetch).

    The arithmetic is that of the JAX package's fetch jit on the same
    sums (``(acc.mean(axis=0)[:n_pairs]) * inv_count``) as XLA compiles
    it: the division by num_chains becomes a multiply by the float32
    1/num_chains, folded into the scalar ``inv_count`` first, so the
    g(g+1)/2 kept panels (the padding past them dropped) take ONE float32
    multiply by ``inv_count * (1/num_chains)``; then
    :func:`cast_for_link`."""
    u = acc[:num_upper_pairs(g) if keep is None else keep]
    u.mul_(_chain_factor(num_chains, inv_count))
    return cast_for_link(u, mode)


def fetch_sd_prep(acc_sq: torch.Tensor, mean: torch.Tensor,
                  num_chains: int, inv_count, bessel, mode: str):
    """The entrywise posterior-SD panels for the link: ``acc_sq``, the
    chains' second-moment sums summed in chain order (CONSUMED: scaled in
    place), and ``mean``, the float32 mean panels :func:`fetch_prep`
    formed from the first-moment sums (its ``acc[:n_pairs]``, scaled).

    The JAX package's ``fetch_sd_jit``: m2 = the sums' chain mean times
    ``inv_count`` (the mean's one multiply), then ``sqrt(max(m2 - mean *
    mean, 0) * bessel)`` in float32 - the square rounded on its own, then
    the difference - and only then :func:`cast_for_link`: the difference
    cancels, so it is never formed in a link dtype."""
    m2 = acc_sq[:mean.shape[0]]
    m2.mul_(_chain_factor(num_chains, inv_count))
    m2.sub_(mean * mean)
    sd = m2.clamp_(min=0.0).mul_(float(np.float32(bessel))).sqrt_()
    return cast_for_link(sd, mode)


def cast_for_link(u: torch.Tensor, mode: str):
    """Down-cast float32 upper panels for the device->host link.

    quant8 is max-abs int8 per panel: one float32 scale per P x P block,
    ``round(u * (127 / scale))`` half to even (a scale of 0 takes 1), so an
    entry is off by at most scale/254; returns ``(q, scale)``.  Every other
    mode returns ``u`` cast to bfloat16 or float16 (round to nearest even),
    or ``u`` itself for float32."""
    if mode == "quant8":
        scale = torch.amax(torch.abs(u), dim=(1, 2))
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        # a true division: Python's 127.0 / tensor is a reciprocal times 127
        ratio = torch.full_like(safe, 127.0).div_(safe)
        q = torch.round(u * ratio[:, None, None]).to(torch.int8)
        return q, scale
    return u.to(LINK_DTYPES[mode])


_STREAMS: dict = {}     # device index -> the fetch's side stream


def _fetch_stream(device: torch.device):
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(index)
    return _STREAMS[index]


class Drain:
    """One tensor's copy to the host, started at construction.

    On the card: at most ``n_slices`` slices of the leading axis, each an
    asynchronous copy into one pinned host buffer on the fetch's side
    stream (which first waits for the work queued so far on the current
    stream) followed by an event; :meth:`wait` waits for the events slice
    by slice, so nothing reads a slice before its event.  The source is
    kept alive until then.  On the CPU the tensor is its own copy."""

    def __init__(self, x: torch.Tensor, n_slices: int = 8):
        x = x.contiguous()
        n = x.shape[0]
        bounds = np.linspace(0, n, min(n_slices, n) + 1).astype(int)
        self.ranges = [(int(a), int(b)) for a, b in zip(bounds[:-1],
                                                        bounds[1:]) if b > a]
        self.events = []
        if x.device.type != "cuda":
            self.host, self._src = x, None
            return
        side = _fetch_stream(x.device)
        side.wait_stream(torch.cuda.current_stream(x.device))
        self.host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        self._src = x
        with torch.cuda.stream(side):
            for a, b in self.ranges:
                self.host[a:b].copy_(x[a:b], non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(side)
                self.events.append(ev)

    def wait(self) -> np.ndarray:
        """The host copy as a numpy array, each slice waited for in turn
        (bfloat16 and float16 widened to float32, exactly, by torch: numpy
        has no bfloat16, and its float16 widening is ~3x slower)."""
        for ev in self.events:
            ev.synchronize()
        self.events, self._src = [], None
        host = self.host
        if host.dtype in (torch.bfloat16, torch.float16):
            host = host.float()
        return host.numpy()


def fetch_upper(acc: torch.Tensor, num_chains: int, g: int, inv_count,
                mode: str) -> np.ndarray:
    """The float32 posterior-mean panels on the host, fetched under a
    non-quant8 ``mode`` (the link carries bfloat16 or float16 for those)."""
    return Drain(fetch_prep(acc, num_chains, g, inv_count, mode)).wait()


def quant8_start(q_dev: torch.Tensor, scale_dev: torch.Tensor,
                 n_slices: int = 8) -> tuple:
    """Start the drain of an int8 panel set: the scales' copy first, then
    the panels' slices, all issued before anything is waited for."""
    scales = Drain(scale_dev, 1)
    return Drain(q_dev, n_slices), scales


def quant8_drain(started: tuple) -> tuple:
    """Wait out a started int8 drain: ``(int8 panels, float32 scales)`` on
    the host."""
    panels, scales = started
    s = scales.wait()
    return panels.wait(), s


def quant8_fetch_assemble(started: tuple, pre: PreprocessResult,
                          phase: dict, *, assemble: bool = True) -> tuple:
    """Drain a started quant8 fetch and assemble the caller-coordinate
    Sigma from the int8 panels in one native pass; returns ``(Sigma or
    None, q8 panels, scales)`` and adds to ``phase``'s fetch_s and
    assemble_s, each a profiler range (``api.fetch``, ``api.assemble``)
    while one records.  ``assemble=False`` is the packed result
    (FitConfig.materialize_sigma): the panels land, no dense stitch."""
    with Phase("api.fetch", phase, "fetch_s"):
        q8, scales = quant8_drain(started)
    if not assemble:
        return None, q8, scales
    with Phase("api.assemble", phase, "assemble_s"):
        Sigma = assemble_q8_sigma(q8, scales, pre)
    return Sigma, q8, scales


def assemble_q8_sigma(q8: np.ndarray, scales: np.ndarray,
                      pre: PreprocessResult) -> np.ndarray:
    """int8 panels -> the caller-coordinate Sigma (de-standardized, zero
    columns reinserted); the fit calls it only where it wants the dense
    Sigma (``materialize_sigma``), so a lazy ingest's refusal is lifted."""
    return assemble_from_q8(q8, scales, pre, destandardize=True,
                            reinsert_zero_cols=True, force=True)


def upload_data(data, upload_dtype: str, device) -> torch.Tensor:
    """The (g, n, P) standardized data on ``device`` as float32, having
    crossed the link in ``upload_dtype`` (:func:`upload_host_array`; the
    device widens it on arrival).  A lazy shard source
    (``utils.preprocess.LazyShardData``, streaming ingest) is uploaded
    block of shards by block of shards into one device tensor allocated
    up front, so the host holds one block (``shards_per_chunk``) at a
    time, never the dense (g, n, P) array; its bytes on the device are
    the dense upload's, bit for bit."""
    device = torch.device(device)
    if isinstance(data, np.ndarray):
        Yd = upload_host_array(data, upload_dtype).to(device)
        return Yd if Yd.dtype == torch.float32 else Yd.float()
    g = data.shape[0]
    Yd = torch.empty(tuple(data.shape), dtype=torch.float32, device=device)
    step = data.shards_per_chunk
    for lo in range(0, g, step):
        hi = min(lo + step, g)
        Yd[lo:hi].copy_(upload_host_array(data.chunk(lo, hi),
                                          upload_dtype).to(device))
    return Yd


def upload_host_array(data: np.ndarray, upload_dtype: str) -> torch.Tensor:
    """The (g, n, P) standardized data as a host tensor in
    ``upload_dtype``, so fewer bytes cross the host->device link: float16
    through numpy, bfloat16 through torch (round to nearest even, as
    ml_dtypes rounds for the JAX package); float32 as it is."""
    if upload_dtype == "float32":
        return torch.from_numpy(data)
    if upload_dtype == "float16":
        return torch.from_numpy(data.astype(np.float16))
    return torch.from_numpy(data).to(torch.bfloat16)


# -- trace-gate registration (analysis/tracecheck.py) ---------------------

@register_trace_entry("runtime.fetch_quant8")
def _trace_fetch_quant8(device: str) -> TraceSpec:
    # the post-hoc quant8 fetch of 2 chains' summed accumulators over g = 4
    # shards (12 padded panels of 8 x 8, 10 kept): fetch_prep, then its
    # cast_for_link
    from dcfm_tpu_torch.models.conditionals import trace_data
    from dcfm_tpu_torch.models.state import num_padded_pairs

    g, num_chains = 4, 2
    acc = trace_data((num_padded_pairs(g), 8, 8), device)
    _, inv_count, _ = accumulator_window(40, 20, 2, 0, num_chains)
    return TraceSpec(
        fn=lambda: fetch_prep(acc, num_chains, g, inv_count, "quant8"),
        device=device, static_key=(g, num_chains, "quant8"))
