"""Parameter functional forms mapping state entries to distribution parameters
(port of ``openmcmc_tpu/parameters.py``).

Ported so far: :class:`Identity` and :class:`ScaledMatrix` (the smoother's
forms) and :class:`LinearCombination` (linear regression), with the gradient
lists the conjugate samplers read and ``LinearCombination.grad``.
``LinearCombinationWithTransform`` comes with reversible jump and the mixture
forms with the mixture slice (ROADMAP.md queue 1: reversible jump; mixture); the
other gradients come with the Metropolis family.

State convention as in the JAX package: state[name] has shape (p, n), p the
dimension and n the replicates; per-chain entries carry leading chain axes,
which every predictor broadcasts.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Dict, List, Sequence, Union

import torch

from openmcmc_tpu_torch.linalg import structured as st


@dataclass(frozen=True)
class Parameter(ABC):
    """Abstract functional form."""

    @abstractmethod
    def predictor(self, state: dict):
        """Evaluate the functional form on the current state."""

    @abstractmethod
    def get_param_list(self) -> List[str]:
        """All state names this form reads."""

    @abstractmethod
    def get_grad_param_list(self) -> List[str]:
        """State names for which the form has a gradient."""


@dataclass(frozen=True)
class Identity(Parameter):
    """f = state[form]."""

    form: str

    def predictor(self, state: dict):
        return state[self.form]

    def get_param_list(self):
        return [self.form]

    def get_grad_param_list(self):
        return [self.form]


@dataclass(frozen=True, init=False)
class LinearCombination(Parameter):
    """f = sum_i state[prefactor_i] @ state[param_i].

    ``form`` maps parameter name -> prefactor (design matrix) name, e.g.
    {"beta": "X"} gives X @ beta; it is held as sorted frozen items. With X data
    (N, p) and a chain-batched beta (chains, p, 1), the predictor broadcasts to
    (chains, N, 1), and over a (chains, draws)-batched store to
    (chains, draws, N, 1)."""

    form: tuple  # ((param, prefactor), ...)

    def __init__(self, form: Union[dict, tuple]):
        items = tuple(sorted(form.items())) if isinstance(form, dict) else tuple(form)
        object.__setattr__(self, "form", items)

    @property
    def form_dict(self) -> Dict[str, str]:
        return dict(self.form)

    def predictor(self, state: dict):
        return self.predictor_conditional(state)

    def predictor_conditional(self, state: dict, term_to_exclude: Union[str, Sequence[str], None] = None):
        """The predictor without the named terms (0 when every term is excluded),
        as the conjugate samplers use it."""
        if term_to_exclude is None:
            term_to_exclude = []
        if isinstance(term_to_exclude, str):
            term_to_exclude = [term_to_exclude]
        total = 0
        for prm, prefactor in self.form:
            if prm not in term_to_exclude:
                total = total + torch.matmul(state[prefactor], state[prm])
        return total

    def get_param_list(self):
        return [prm for prm, _ in self.form] + [pre for _, pre in self.form]

    def get_grad_param_list(self):
        return [prm for prm, _ in self.form]

    def grad(self, state: dict, param: str) -> torch.Tensor:
        """d predictor / d param: the prefactor transposed, (p, N)."""
        return state[self.form_dict[param]].mT


@dataclass(frozen=True)
class ScaledMatrix(Parameter):
    """f = scalar * matrix: the scalar-precision-times-penalty form. The matrix
    entry may be structured or a raw (p, p) tensor; the predictor is structured."""

    matrix: str
    scalar: str

    def predictor(self, state: dict) -> st.Structured:
        return st.scale(state[self.scalar], st.as_structured(state[self.matrix]))

    def get_param_list(self):
        return [self.scalar, self.matrix]

    def get_grad_param_list(self):
        return [self.scalar]
