"""Whether a fit's answer is correct: the program's posterior mean held
against the plain reference's (the file the configuration names under
``reference``, ``fitref/gibbs.py`` for the built-in priors) for the same
data, config and run seed.

The two consume the same variates, so a sound fit differs from the
reference by rounding alone.  The numbers compared, each against the
limit its configuration file states:

* a dense answer (``FitResult.Sigma``, the float32 fetch assembled in
  the caller's coordinates): ``sigma_rel_err``, the Frobenius norm of the
  difference over the reference's, and ``sigma_max_err``, the largest
  entry of the difference over the reference's largest entry;
* a packed quant8 answer read through ``FitResult.sigma_block``: the
  reference's mean quantized by the link's rule (max-abs int8 per panel,
  round half to even), then ``q8_code_mismatch``, the share of entries
  more than a quarter of a quantization step from the reference's code,
  and ``q8_scale_err``, the largest relative gap between a panel's scale
  (its largest |entry|) and the reference's.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import torch

from fitbench import spec
from fitref import gibbs


def reference_module(config: dict):
    """The plain reference the configuration names under ``reference``, a
    path relative to the checkout's root; there is no default.  Loaded
    once a process, in a run's set-up: a missing file fails before the
    window, and no module is executed after it (doing so there doubled
    the time of the q8 comparison's host reads on the card)."""
    name = config.get("name", "?")
    path = config.get("reference")
    if not path:
        raise KeyError(f"configuration {name!r} names no reference")
    module = "fitbench_reference_" + re.sub(r"\W", "_", path)
    if module in sys.modules:
        return sys.modules[module]
    try:
        return spec.load_module(os.path.join(spec.ROOT, path), module)
    except FileNotFoundError:
        raise FileNotFoundError(f"configuration {name!r}: its reference "
                                f"{path!r} is not a file") from None


def reference(Y: np.ndarray, config: dict, traffic: dict, seed: int,
              device, *, tf32: bool = False, dtype=torch.float32):
    """The reference's ``(panels, prepared)`` in ``dtype``; ``tf32`` runs
    its float32 products in TF32 (the control), else in full float32."""
    ref = reference_module(config)
    cuda = torch.device(device).type == "cuda"
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32) and cuda
    try:
        model = dict(config["model"], **config["backend"])
        return ref.posterior_mean(
            Y, model, traffic, seed, int(config["run"]["num_chains"]),
            device, dtype=dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _block_grid(panels: torch.Tensor, g: int) -> torch.Tensor:
    """(g(g+1)/2, P, P) upper panels -> the dense (g P, g P) matrix in
    shard coordinates, diagonal blocks symmetrized."""
    U, P, _ = panels.shape
    r, c = gibbs.upper_pairs(g)
    r = torch.as_tensor(r, device=panels.device)
    c = torch.as_tensor(c, device=panels.device)
    grid = torch.empty((g, g, P, P), dtype=panels.dtype,
                       device=panels.device)
    grid[r, c] = panels
    grid[c, r] = panels.transpose(1, 2)
    d = torch.arange(g, device=panels.device)
    grid[d, d] = 0.5 * (grid[d, d] + grid[d, d].transpose(1, 2))
    return grid.permute(0, 2, 1, 3).reshape(g * P, g * P)


def dense_sigma(panels: torch.Tensor, prep) -> torch.Tensor:
    """The reference's posterior mean in the caller's coordinates:
    de-standardized, padding dropped, all-zero columns zero."""
    g = prep.col_scale.shape[0]
    S = _block_grid(panels, g)
    s = torch.as_tensor(prep.col_scale.reshape(-1), device=panels.device,
                        dtype=panels.dtype)
    S *= s[:, None] * s[None, :]
    out_map = prep.out_map()
    idx = torch.as_tensor(np.flatnonzero(out_map >= 0), device=S.device)
    dest = torch.as_tensor(out_map[out_map >= 0], device=S.device)
    full = torch.zeros((prep.p_original, prep.p_original), dtype=S.dtype,
                       device=S.device)
    full[dest[:, None], dest[None, :]] = S[idx][:, idx]
    return full


def _ratio(name: str, got: float, plain: float) -> dict:
    """A gap from the exact chain, the plain float32 chain's, and their
    ratio (a plain gap of 0 counts as the smallest float32 step)."""
    return {name: got, name + "_f32": plain,
            name + "_ratio": got / max(plain, 2.0 ** -24)}


def sigma_numbers(Sigma: np.ndarray, exact: torch.Tensor,
                  plain: torch.Tensor, prep) -> dict:
    ref = dense_sigma(exact, prep)
    norm = torch.linalg.vector_norm(ref)

    def gap(S):
        return float(torch.linalg.vector_norm(S.double() - ref) / norm)
    got = gap(torch.as_tensor(Sigma, device=ref.device))
    return _ratio("sigma_err", got, gap(dense_sigma(plain, prep)))


def quantize(u: torch.Tensor) -> tuple:
    """The link's quant8 rule: per panel the scale max|u|, codes
    round(u * 127 / scale) half to even; returns (codes in u's dtype,
    scale)."""
    scale = torch.amax(torch.abs(u), dim=(1, 2))
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    ratio = torch.full_like(safe, 127.0).div_(safe)
    return torch.round(u * ratio[:, None, None]), scale


def _symmetrize(x: torch.Tensor, diag: torch.Tensor) -> torch.Tensor:
    return torch.where(diag[:, None, None], 0.5 * (x + x.transpose(1, 2)),
                       x)


def q8_numbers(block, exact: torch.Tensor, plain: torch.Tensor, prep, *,
               batch: int = 2048) -> dict:
    """``block(i, j)``: the answer's de-standardized (P, P) block of shard
    pair (i, j), diagonal blocks symmetrized (``FitResult.sigma_block``).
    The exact chain's panels are quantized by the link's rule; the answer
    and the plain chain's quantized panels are read against its codes."""
    g = prep.col_scale.shape[0]
    r, c = gibbs.upper_pairs(g)
    dev = exact.device
    s = torch.as_tensor(prep.col_scale, device=dev, dtype=torch.float64)
    miss = [0, 0]
    entries = 0
    scale_err = [[], []]
    for q0 in range(0, r.size, batch):
        rq, cq = r[q0:q0 + batch], c[q0:q0 + batch]
        got = torch.as_tensor(np.stack([block(int(i), int(j))
                                        for i, j in zip(rq, cq)]),
                              device=dev).double()
        diag = torch.as_tensor(rq == cq, device=dev)
        ss = (s[torch.as_tensor(rq, device=dev)][:, :, None]
              * s[torch.as_tensor(cq, device=dev)][:, None, :])
        codes, scale = quantize(exact[q0:q0 + batch])
        step = torch.where(scale > 0, scale, torch.ones_like(scale)) / 127.0
        want = _symmetrize(codes, diag)
        pc, pscale = quantize(plain[q0:q0 + batch])
        plain_deq = _symmetrize(pc * (pscale / 127.0)[:, None, None],
                                diag).double()
        for k, unit in enumerate((got / ss, plain_deq)):
            steps = unit / step[:, None, None] - want
            miss[k] += int((steps.abs() > 0.25).sum())
            scale_err[k].append(torch.abs(torch.amax(unit.abs(), dim=(1, 2))
                                          - scale) / (127.0 * step))
        entries += codes.numel()
    out = _ratio("q8_mismatch", miss[0] / entries, miss[1] / entries)
    med = [float(torch.cat(e).median()) for e in scale_err]
    out.update(_ratio("q8_scale_err", med[0], med[1]))
    return out


def control_answer(config: dict, panels: torch.Tensor, prep):
    """The control's output in the program's answer form: the dense
    Sigma, or a ``block(i, j)`` reader of quant8 panels."""
    if config["answer"] == "sigma":
        return dense_sigma(panels, prep).cpu().numpy()
    codes, scale = quantize(panels)
    deq = (codes * (scale / 127.0)[:, None, None]).cpu().numpy()
    g = prep.col_scale.shape[0]
    s = prep.col_scale

    def block(i, j):
        lo, hi = min(i, j), max(i, j)
        b = deq[lo * g - lo * (lo - 1) // 2 + (hi - lo)]
        b = 0.5 * (b + b.T) if i == j else (b if i < j else b.T)
        return b * (s[i][:, None] * s[j][None, :])
    return block


def numbers(config: dict, answer, exact: torch.Tensor, plain: torch.Tensor,
            prep) -> dict:
    """Every number of an answer against the exact (float64) chain, beside
    the plain float32 chain's and their ratio."""
    if config["answer"] == "sigma":
        return sigma_numbers(answer, exact, plain, prep)
    return q8_numbers(answer, exact, plain, prep)


def judge(config: dict, traffic: dict, Y: np.ndarray, seed: int, answer,
          device) -> dict:
    """The numbers of ``answer``, a fit of ``Y`` on run seed ``seed``: the
    reference chain run in float64 (the exact chain: the same variates,
    rounding far below float32's) and in float32 (the plain chain), the
    answer's gap from the exact chain and the plain chain's, and the
    ratio of the two.  The ratio is the answer's rounding error in units
    of a plain float32 implementation's on the same seed, so it stays put
    where the chain itself amplifies rounding."""
    exact, prep = reference(Y, config, traffic, seed, device,
                            dtype=torch.float64)
    plain, _ = reference(Y, config, traffic, seed, device)
    return numbers(config, answer, exact, plain, prep)


def verdict(config: dict, got: dict) -> tuple:
    """(correct, [(name, value, limit)]): every number the configuration
    sets a limit for at or under it (a number that is not finite
    fails)."""
    rows = [(k, got[k], float(lim)) for k, lim in config["limits"].items()]
    ok = all(np.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
