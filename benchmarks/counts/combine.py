"""A saved draw's combine: the packed posterior-mean panels of the U =
G(G+1)/2 upper shard pairs added to the accumulator.

Operations: the factor cross-moments H_rc = eta_r' eta_c / n of every
shard pair, then Lam_r H_rc Lam_c' for each upper pair, the diagonal
pairs' 1/ps, and the add.  Bytes: the packed accumulator read once and
written once (U P x P float32 panels), plus the draw's loadings,
residual precisions and factors read once.  Both count what the result
needs, whatever implements it, so a fused combine stays comparable.
"""


def pairs(G: int) -> int:
    return G * (G + 1) // 2


def flops(s: dict) -> float:
    G, n, P, K = s["G"], s["n"], s["P"], s["K"]
    U = pairs(G)
    H = 2.0 * G * G * n * K * K
    panels = U * (2.0 * P * K * K + 2.0 * P * P * K)
    return H + panels + G * P + U * P * P


def nbytes(s: dict) -> float:
    G, n, P, K = s["G"], s["n"], s["P"], s["K"]
    acc = 2.0 * pairs(G) * P * P * 4
    inputs = 4.0 * (G * P * K + G * P + G * n * K + n * K)
    return acc + inputs
