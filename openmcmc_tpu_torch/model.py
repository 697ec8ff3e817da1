"""Model: distributions keyed by response (port of ``openmcmc_tpu/model.py``).

``conditional()`` is static analysis over parameter names; ``log_p`` sums the
component log-densities, per chain when the state carries leading chain axes. Gradients come with the Metropolis family
(ROADMAP.md queue 1: Metropolis family).
"""

from __future__ import annotations

from typing import Dict, List, Optional

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
