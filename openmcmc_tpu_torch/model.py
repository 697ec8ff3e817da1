"""Model: distributions keyed by response (port of ``openmcmc_tpu/model.py``).

``conditional()`` is static analysis over parameter names; ``log_p`` and
``grad_log_p`` sum the components, per chain when the state carries leading
chain axes.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from openmcmc_tpu_torch.distributions.base import Distribution


class Model(dict):
    """Dictionary of distributions keyed by their response names.

    Attributes:
        response: optional dict mapping data names -> predictor attribute names, used
            by the driver to store fitted values.
    """

    def __init__(self, distributions: List[Distribution], response: Optional[Dict[str, str]] = None):
        super().__init__({dist.response: dist for dist in distributions})
        self.response = response

    def conditional(self, param: str) -> "Model":
        """Sub-model of the distributions that depend on ``param``."""
        return Model([dist for dist in self.values() if param in dist.param_list])

    def log_p(self, state: dict, log_dets: Optional[Dict[str, float]] = None):
        """Sum of component log-densities; with chain-batched entries, one value
        per chain. ``log_dets`` maps a Normal's response name to the log|P| of
        its ScaledMatrix precision, computed once by the caller."""
        log_dets = log_dets or {}
        total = 0.0
        for name, dist in self.items():
            if name in log_dets:
                total = total + dist.log_p(state, log_det=log_dets[name])
            else:
                total = total + dist.log_p(state)
        return total

    def grad_log_p(self, state: dict, param: str, hessian_required: bool = True):
        """Summed gradient (the entry's shape, (..., p, n)) and NEGATIVE Hessian
        ((..., d, d), d = p n) over the components. A component's Hessian built
        from data alone (a linear mean's n X'WX with X data) stays unbatched and
        broadcasts against the per-chain ones."""
        x = state[param]
        d = x.shape[-2] * x.shape[-1]
        grad_sum = torch.zeros_like(x)
        if not hessian_required:
            for dist in self.values():
                grad_sum = grad_sum + dist.grad_log_p(state, param, hessian_required=False)
            return grad_sum
        hessian_sum = torch.zeros((d, d), dtype=x.dtype, device=x.device)
        for dist in self.values():
            grad, hess = dist.grad_log_p(state, param, hessian_required=True)
            grad_sum = grad_sum + grad
            hessian_sum = hessian_sum + hess.reshape(hess.shape[:-2] + (d, d))
        return grad_sum, hessian_sum
