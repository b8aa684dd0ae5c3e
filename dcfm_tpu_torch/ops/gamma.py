"""Gamma-family samplers, rate convention throughout.

The port of ``dcfm_tpu/ops/gamma.py``.  Each sampler takes its raw unit
variates from a ``Draws`` object (dcfm_tpu_torch/noise.py) at a given
site, and applies the same constructions in the same order as the JAX
package, so fed the same variates both return the same draws.
"""

from __future__ import annotations

import math

import torch


def _out_shape(rate: torch.Tensor, sample_shape):
    if sample_shape is None:
        return tuple(rate.shape)
    if isinstance(sample_shape, int):
        return (sample_shape,)
    return tuple(sample_shape)


def gamma_rate(draws, site: int, shape, rate, *, sample_shape=None,
               part=None, device=None) -> torch.Tensor:
    """Gamma(shape, rate) draws.

    A small static half-integer shape (2*shape integer, shape <= 2) takes
    the rejection-free path: Gamma(1, r) = Exp(1)/r and Gamma(k/2, r) =
    chi^2_k / (2r).  Other shapes take standard-Gamma variates."""
    # built on the device (torch.full), never copied from the host: a
    # host-to-device copy cannot be captured into a CUDA graph
    if isinstance(rate, torch.Tensor):
        rate = rate.to(torch.float32)
    else:
        rate = torch.full((), rate, dtype=torch.float32, device=device)
    out_shape = _out_shape(rate, sample_shape)
    rate_b = torch.broadcast_to(rate, out_shape)
    if (not isinstance(shape, torch.Tensor) and float(2 * float(shape))
            .is_integer() and 0 < shape <= 2):
        tw = int(2 * float(shape))
        if tw == 2:
            g = draws.exponential(site, out_shape, part=part)
        else:
            z = draws.normal(site, out_shape + (tw,), part=part)
            g = 0.5 * torch.sum(z * z, dim=-1)
        return g / rate_b
    if isinstance(shape, torch.Tensor):
        alpha = torch.broadcast_to(shape.to(torch.float32),
                                   out_shape).contiguous()
    else:
        alpha = torch.full(out_shape, shape, dtype=torch.float32,
                           device=rate.device)
    return draws.standard_gamma(site, alpha, part=part) / rate_b


def gamma_unit_static(draws, site: int, shape: float, sample_shape, *,
                      device=None, max_exp_terms: int = 1024) -> torch.Tensor:
    """Gamma(shape, 1) for a large static half-integer shape, rejection
    free: for s = m + h (integer m, h in {0, 1/2}) the sum of m Exp(1)
    terms (part 0) plus z^2/2 for one standard normal (part 1).  Other
    shapes, or m > max_exp_terms, take standard-Gamma variates."""
    a = float(shape)
    if a <= 0:
        raise ValueError(f"gamma shape must be positive, got {a!r}")
    out_shape = ((sample_shape,) if isinstance(sample_shape, int)
                 else tuple(sample_shape))
    m = int(math.floor(a + 1e-9))
    frac = a - m
    half = abs(frac - 0.5) < 1e-9
    if (frac > 1e-9 and not half) or m > max_exp_terms:
        alpha = torch.full(out_shape, a, dtype=torch.float32, device=device)
        return draws.standard_gamma(site, alpha)
    g = torch.zeros(out_shape, dtype=torch.float32, device=device)
    if m:
        g = torch.sum(draws.exponential(site, out_shape + (m,), part=0),
                      dim=-1)
    if half:
        z = draws.normal(site, out_shape, part=1)
        g = g + 0.5 * z * z
    return g


def gamma_rate_half_integer(draws, site: int, twice_shape: torch.Tensor,
                            rate: torch.Tensor, *, max_twice: int,
                            part=None) -> torch.Tensor:
    """Exact Gamma(k/2, rate) for integer k = ``twice_shape`` (elementwise):
    half the sum of k squared standard normals, over ``max_twice`` normals
    drawn per element and masked."""
    z = draws.normal(site, tuple(twice_shape.shape) + (max_twice,),
                     part=part)
    mask = (torch.arange(max_twice, device=z.device)
            < twice_shape[..., None])
    chi2 = torch.sum(torch.where(mask, z * z, torch.zeros((), device=z.device)),
                     dim=-1)
    return 0.5 * chi2 / rate


def inverse_gamma_rate(draws, site: int, shape, scale, *, sample_shape=None,
                       part=None, device=None) -> torch.Tensor:
    """InvGamma(shape, scale): 1/x with x ~ Gamma(shape, rate=scale), the
    horseshoe's auxiliary conditionals."""
    return 1.0 / gamma_rate(draws, site, shape, scale,
                            sample_shape=sample_shape, part=part,
                            device=device)
