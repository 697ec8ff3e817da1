"""Result-layout helpers of the fused engines (port of ``openmcmc_tpu/fused/layout.py``).

``chain_slice`` is not ported: it dodges an XLA copy of a no-op slice, and the
port's kernels write exactly ``n_chains`` rows. ``chain_rows``, the per-chain
(lam, tau) input rows that the conjugate engines' runners share, is the port's
own.
"""

from __future__ import annotations

import torch


def store_index(it: int, n_burn: int, n_thin: int) -> int:
    """In-kernel thinning: the stored-draw index of sweep ``it``, or -1 if unstored.

    Generic-driver semantics: every stored iteration runs ``n_thin`` full sweeps
    and the state after the n_thin-th is stored. Engines run
    ``n_burn + n_keep * n_thin`` sweeps; ``n_burn`` here is the SWEEP count (the
    driver's n_burn * n_thin). ``csrc/spectral_smoother.cu`` carries the same
    function for the card."""
    rel = it - n_burn
    if rel < 0:
        return -1
    if n_thin == 1:
        return rel
    return rel // n_thin if rel % n_thin == n_thin - 1 else -1


def chain_rows(n_chains, lam0, tau0, init, device):
    """The kernels' (chains,) float32 rows of initial lam and tau on ``device``:
    ``init["lam"]``/``init["tau"]`` when a warm start is given, else lam0/tau0
    (scalars or per-chain values) broadcast over chains."""
    if init is not None:
        lam0, tau0 = init["lam"], init["tau"]
    return [torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1).expand(n_chains).contiguous()
            for v in (lam0, tau0)]
