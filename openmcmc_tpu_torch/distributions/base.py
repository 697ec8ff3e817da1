"""Distribution base class (port of ``openmcmc_tpu/distributions/base.py``).

``log_p`` returns the POSITIVE log-density, as in the JAX package; state[name]
is (p, n), p the dimension and n the replicates, with leading chain axes on the
per-chain entries. ``grad_log_p`` returns the gradient of the POSITIVE log-p and
the NEGATIVE Hessian; its default is exact autodiff through ``log_p``
(``torch.func.grad`` / ``torch.func.hessian``, vmapped over the chain axes), and
the finite-difference versions are kept as its independent cross-check.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List

import torch


@dataclass(frozen=True)
class Distribution(ABC):
    """Abstract distribution keyed by its response state name."""

    response: str

    @abstractmethod
    def log_p(self, state: dict, by_observation: bool = False):
        """POSITIVE log-density under the current state (scalar, or (n,) per observation)."""

    @property
    @abstractmethod
    def _dist_params(self) -> List[str]:
        """State names used by the distribution's parameters (excluding the response)."""

    @property
    def param_list(self) -> List[str]:
        """All state names, response included."""
        return [self.response] + self._dist_params

    def grad_log_p(self, state: dict, param: str, hessian_required: bool = True):
        """Gradient (and negative Hessian) of log_p with respect to a state entry,
        by exact autodiff through log_p: the gradient has the entry's shape
        (..., p, n), the Hessian is (..., d, d) over the flattened d = p n, one
        per chain. Subclasses override with analytic forms."""
        grad = self._autodiff(state, param, torch.func.grad)
        if hessian_required:
            return grad, -self._autodiff(state, param, torch.func.hessian)
        return grad

    # -- finite-difference cross-checks --------------------------------------

    @staticmethod
    def _moved(state: dict, param: str, k: int, delta: float) -> dict:
        """The state with flattened coordinate k of ``param`` moved by delta."""
        x = state[param]
        flat = x.reshape(x.shape[:-2] + (-1,)).clone()
        flat[..., k] += delta
        moved = dict(state)
        moved[param] = flat.reshape(x.shape)
        return moved

    def grad_log_p_diff(self, state: dict, param: str, step_size: float = 1e-4) -> torch.Tensor:
        """Central-difference gradient of log_p, the entry's shape."""
        x = state[param]
        h = step_size / 2.0
        cols = [(self.log_p(self._moved(state, param, k, h)) - self.log_p(self._moved(state, param, k, -h))) / step_size
                for k in range(x.shape[-2] * x.shape[-1])]
        return torch.stack(cols, dim=-1).reshape(x.shape)

    def hessian_log_p_diff(self, state: dict, param: str, step_size: float = 1e-4) -> torch.Tensor:
        """Finite-difference NEGATIVE Hessian (..., d, d): differences of
        :meth:`grad_log_p_diff` along each coordinate."""
        x = state[param]
        d, h = x.shape[-2] * x.shape[-1], step_size / 2.0
        cols = []
        for k in range(d):
            g_plus = self.grad_log_p_diff(self._moved(state, param, k, h), param, step_size)
            g_minus = self.grad_log_p_diff(self._moved(state, param, k, -h), param, step_size)
            cols.append((g_minus - g_plus).reshape(x.shape[:-2] + (d,)) / step_size)
        return torch.stack(cols, dim=-1)

    # -- autodiff -------------------------------------------------------------

    def _autodiff(self, state: dict, param: str, transform):
        """``transform`` (torch.func.grad or hessian) of the summed log_p with
        respect to the flattened entry, vmapped over its leading chain axes: the
        tensors whose leading axes equal the entry's are sliced per chain, all
        else (data) is shared. Returns the gradient in the entry's shape, or the
        (..., d, d) Hessian."""
        x = state[param]
        batch, shape = tuple(x.shape[:-2]), tuple(x.shape[-2:])
        nb = len(batch)
        n_batch = 1
        for size in batch:
            n_batch *= size
        batched = {name: v.reshape((n_batch,) + tuple(v.shape[nb:])) for name, v in state.items()
                   if nb and name != param and torch.is_tensor(v) and v.dim() == nb + 2
                   and tuple(v.shape[:nb]) == batch}

        def fn(flat, per_chain):
            new_state = dict(state)
            new_state.update(per_chain)
            new_state[param] = flat.reshape(shape)
            return torch.sum(self.log_p(new_state))

        flat = x.reshape((n_batch, -1))
        if nb == 0:
            out = transform(fn)(flat[0], batched)
        else:
            out = torch.func.vmap(transform(fn))(flat, batched)
        if transform is torch.func.grad:
            return out.reshape(x.shape)
        d = flat.shape[-1]
        return out.reshape(batch + (d, d))
