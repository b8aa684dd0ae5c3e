"""K5 (sse_ps), one launch over B = G P features: sse_j = max(yty_j - 2
Lam_j . EYt_j + Lam_j . M_j, 0) and ps_j = g_j / (bs + sse_j / 2).
Bytes: Lam_j, M_j, EYt_j (K each), yty_j and g_j read once, ps_j and
sse_j written once, float32."""


def flops(s: dict) -> float:
    return float(s["G"] * s["P"] * (4 * s["K"] + 6))


def nbytes(s: dict) -> float:
    return 4.0 * s["G"] * s["P"] * (3 * s["K"] + 4)
