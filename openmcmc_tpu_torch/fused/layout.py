"""Result-layout helpers of the fused engines (port of ``openmcmc_tpu/fused/layout.py``).

``chain_slice`` is not ported: it dodges an XLA copy of a no-op slice, and the
port's kernels write exactly ``n_chains`` rows. ``chain_rows``, the per-chain
(lam, tau) input rows that the conjugate engines' runners share, is the port's
own, as are the two transfer helpers: :func:`upload`, which counts each
host-to-device copy of an engine's inputs, and :func:`to_host`, which counts
each read from the card.
"""

from __future__ import annotations

import torch

from openmcmc_tpu_torch.utils import profiling


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
    return [upload(v, device).reshape(-1).expand(n_chains).contiguous() for v in (lam0, tau0)]


def upload(value, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=torch.float32, device=device)``. A host
    value bound for the card is converted on the host and copied (one pageable
    copy, which waits for the stream), counted as ``h2d.copies`` and
    ``h2d.bytes``."""
    device = torch.device(device)
    if device.type == "cpu" or (torch.is_tensor(value) and value.device.type != "cpu"):
        return torch.as_tensor(value, dtype=torch.float32, device=device)
    host = torch.as_tensor(value, dtype=torch.float32)
    profiling.count("h2d.copies")
    profiling.count("h2d.bytes", host.numel() * host.element_size())
    return host.to(device)


def to_host(value: torch.Tensor) -> torch.Tensor:
    """``value`` on the host. A copy off the card waits for it: each is
    counted as ``sync.host_reads``."""
    if value.device.type != "cpu":
        profiling.count("sync.host_reads")
    return value.detach().cpu()
