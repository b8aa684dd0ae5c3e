"""Operations of one Gibbs sweep of one chain, from its shapes: G shards
of n rows and P columns, K factors a shard.

Counted are the products and factorisations the model needs, each
multiply and add once: the (n, P) x (P, K) and (K, n) x (n, P) products
of the Z, X and Lambda updates, the K x K moments, the Cholesky factors
and triangular solves of the Z, X and per-row Lambda draws, the residual
sums of squares, and the elementwise forming of the residuals.  The
shrinkage prior's and the draws' elementwise work is counted at 10
operations per loading, below what either prior does, so the count
never exceeds the work.
"""


def chol_solve_flops(K: int, rhs: int) -> float:
    """One K x K Cholesky factor, then per right-hand side a forward and
    a backward solve, and one more backward solve for the noise."""
    return K ** 3 / 3.0 + rhs * 3 * K * K


def flops(s: dict) -> float:
    G, n, P, K = s["G"], s["n"], s["P"], s["K"]
    gemm = 2.0 * G * n * P * K
    total = 0.0
    total += 2.0 * G * P * K * K + G * P * K       # Lam' W and W = Lam ps
    total += gemm + 2.0 * G * n * P               # R = Y - a X Lam'
    total += gemm                                 # R W (Z update)
    total += G * chol_solve_flops(K, n)           # Z draws
    total += gemm + 2.0 * G * n * P               # R = Y - b Z Lam'
    total += gemm                                 # R W (X update)
    total += chol_solve_flops(K, n)               # X draws
    total += 3.0 * G * n * K                      # eta
    total += 2.0 * G * n * K * K                  # E = eta' eta
    total += gemm                                 # EY = eta' Y
    total += 3.0 * G * P * K * K                  # Q_j, b_j
    total += G * P * chol_solve_flops(K, 1)       # Lambda rows
    total += 10.0 * G * P * K                     # prior
    total += 2.0 * G * n * P                      # yty
    total += 2.0 * G * P * K * K + 4.0 * G * P * K + 6.0 * G * P  # psi
    return total
