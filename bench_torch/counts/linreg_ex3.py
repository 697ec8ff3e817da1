"""Float32 operations and bytes of one ``linreg_ex3`` fit: the Gibbs run of
the small-p linear regression, counted from the kernel source
(``csrc/linreg.cu``: the normals, an unrolled Cholesky of the p x p
conditional precision, both triangular solves, the two quadratic forms and the
Gamma draws; transcendentals, square roots and divisions one each). The same
work whatever kernels implement it, so another engine is held to it too. The
sufficient statistics X'X and X'y (once a fit) are not counted."""

FLOP_PER_NORMAL = 30   # one inverse-CDF normal per coefficient
FLOP_PER_SWEEP = 100   # the tau and the lam Gamma draw, one Marsaglia-Tsang round each, and the rates
FLOP_PER_STORE = 30    # the analytic log posterior


def flop_per_sweep(p: int) -> int:
    """Operations per chain and sweep."""
    chol = sum(4 + 2 * j + (p - 1 - j) * (2 + 2 * j) for j in range(p))
    solves = sum(4 + 2 * i for i in range(p)) + sum(2 + 2 * (p - 1 - i) for i in range(p))
    return FLOP_PER_NORMAL * p + chol + solves + (3 + 3 * p) * p + 4 * p + FLOP_PER_SWEEP


def fit(cfg: dict) -> tuple:
    """(flop, bytes) of one fit; bytes count each input read once and each output
    written once: G, c, the prior's diagonal and mean, the scalars and lam0/tau0
    in; beta, lam, tau, log_post out."""
    p, chains = len(cfg["beta_true"]), cfg["n_chains"]
    keep, sweeps = cfg["n_iter"], cfg["n_burn"] + cfg["n_iter"]
    flop = chains * (sweeps * flop_per_sweep(p) + keep * FLOP_PER_STORE)
    n_bytes = 4 * (p * p + 3 * p + 3 + 2 * chains + chains * keep * (p + 3))
    return float(flop), float(n_bytes)
