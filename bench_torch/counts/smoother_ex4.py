"""Float32 operations and bytes of one ``smoother_ex4`` fit: the Gibbs run of
the spectral smoother, counted from the kernel source (``csrc/spectral_smoother.cu``,
transcendentals, square roots and divisions one each, Philox's integer rounds
not counted). The same work whatever kernels implement it, so the generic
driver's fit is held to it too. Host preparation (a p x p eigendecomposition)
is not counted."""

FLOP_PER_COORD = 49   # inverse-CDF normal 30, w draw 12, quadratic forms 7
FLOP_PER_SWEEP = 100  # the (lam, tau) Gamma pair, one Marsaglia-Tsang round each, and the rates
FLOP_PER_STORE = 30   # the analytic log posterior; the store adds 2 p^2 for b = V w


def fit(cfg: dict) -> tuple:
    """(flop, bytes) of one fit; bytes count each input read once and each output
    written once: V, the eigenvalues and projections, lam0/tau0 in; b, lam,
    tau, log_post out."""
    p, chains = cfg["n_time"], cfg["n_chains"]
    keep, sweeps = cfg["n_iter"], cfg["n_burn"] + cfg["n_iter"]
    flop = chains * (sweeps * (FLOP_PER_COORD * p + FLOP_PER_SWEEP) + keep * (2 * p * p + FLOP_PER_STORE))
    n_bytes = 4 * (p * p + 3 * p + 2 * chains + chains * keep * (p + 3))
    return float(flop), float(n_bytes)
