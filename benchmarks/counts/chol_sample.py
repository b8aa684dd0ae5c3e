"""K1 (chol_sample), one launch over B = G P systems of K: x_j = Q_j^-1
b_j + L_j^-T z_j.  Bytes: Q_j (K x K), b_j, z_j read once and x_j
written once, float32.  Operations: the Cholesky factor, one forward and
two backward solves, and the sum, each multiply, add, divide and square
root once."""


def flops(s: dict) -> float:
    K = s["K"]
    chol = sum(2 * (K - j) * j + 1 + (K - 1 - j) for j in range(K))
    fwd = sum(2 * j + 1 for j in range(K))
    bwd = sum(4 * (K - 1 - j) + 3 for j in range(K))
    return float(s["G"] * s["P"] * (chol + fwd + bwd + K))


def nbytes(s: dict) -> float:
    K = s["K"]
    return 4.0 * s["G"] * s["P"] * (K * K + 3 * K)
