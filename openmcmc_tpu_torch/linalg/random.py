"""Special functions for the samplers (port of ``openmcmc_tpu/linalg/random.py``).

Ported so far: :func:`fast_erfinv`, which the generic driver's truncated-normal
draws use. It is not ``fused.prng.erfinv_poly``: the two clamp differently
(1e-37 on 1 - x^2 here, 1e-30 on w there) and branch differently, as in the
JAX package, so each keeps its own copy. ``fast_gamma`` comes with kernel K12
(ROADMAP.md queue 1: kernel K12).
"""

from __future__ import annotations

import torch

_CENTRAL = (3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
            -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_TAIL = (0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
         -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def fast_erfinv(x: torch.Tensor) -> torch.Tensor:
    """Single-precision inverse erf (Giles 2012): both polynomial branches in
    w = -log(1 - x^2), evaluated everywhere and selected at w < 5."""
    w = -torch.log(torch.clamp((1.0 - x) * (1.0 + x), min=1e-37))
    wc = w - 2.5
    p1 = torch.full_like(x, 2.81022636e-08)
    for coef in _CENTRAL:
        p1 = coef + p1 * wc
    wt = torch.sqrt(torch.clamp(w, min=5.0)) - 3.0
    p2 = torch.full_like(x, -0.000200214257)
    for coef in _TAIL:
        p2 = coef + p2 * wt
    return torch.where(w < 5.0, p1, p2) * x
