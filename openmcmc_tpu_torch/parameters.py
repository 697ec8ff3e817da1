"""Parameter functional forms mapping state entries to distribution parameters
(port of ``openmcmc_tpu/parameters.py``).

Ported so far: :class:`Identity` and :class:`ScaledMatrix` (the smoother's
forms), :class:`LinearCombination` (linear regression), with the gradient lists
the conjugate samplers read and ``LinearCombination.grad``, and the mixture forms
:class:`MixtureParameterVector` and :class:`MixtureParameterMatrix`.
``LinearCombinationWithTransform`` comes with the examples (ROADMAP.md queue 1:
examples and entry): only the Poisson-GMRF example uses it.

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


@dataclass(frozen=True)
class MixtureParameter(Parameter, ABC):
    """Allocation-indexed forms: ``state[allocation]`` holds one component index
    per point, (..., n, 1) with chain axes where it is sampled."""

    param: str
    allocation: str

    def indices(self, state: dict) -> torch.Tensor:
        """The component index of every point, (..., n)."""
        alloc = state[self.allocation]
        return alloc.reshape(alloc.shape[:-2] + (-1,))

    def get_element_match(self, state: dict, element_index) -> torch.Tensor:
        """int32 indicator of allocation == element_index: (..., 1, n) for a
        scalar index, (..., m, n) for an index vector of length m."""
        alloc = self.indices(state)
        index = torch.as_tensor(element_index, device=alloc.device)
        return (alloc[..., None, :] == index.reshape(-1, 1)).to(torch.int32)

    def get_param_list(self):
        return [self.param, self.allocation]


def _gather_components(vals: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """Rows ``alloc`` of the component table ``vals`` (..., m, r) for the
    indices ``alloc`` (..., n): (..., n, r), batch axes broadcast. A gather
    stands where the JAX package contracts with a one-hot matrix (a TPU
    workaround for per-chain gathers)."""
    batch = torch.broadcast_shapes(vals.shape[:-2], alloc.shape[:-1])
    n, r = alloc.shape[-1], vals.shape[-1]
    index = alloc.to(torch.int64).expand(batch + (n,))[..., None].expand(batch + (n, r))
    return torch.gather(vals.expand(batch + tuple(vals.shape[-2:])), -2, index)


@dataclass(frozen=True)
class MixtureParameterVector(MixtureParameter):
    """f = state[param][state[allocation]]: each point's component value,
    (..., n, r) for a (..., m, r) component table."""

    def predictor(self, state: dict) -> torch.Tensor:
        return _gather_components(state[self.param], self.indices(state))

    def grad(self, state: dict, param: str) -> torch.Tensor:
        """d predictor / d param: the (..., m, n) allocation indicator."""
        n_components = state[param].shape[-2]
        index = torch.arange(n_components, device=state[param].device)
        return self.get_element_match(state, index).to(state[param].dtype)

    def get_grad_param_list(self):
        return [self.param]


@dataclass(frozen=True)
class MixtureParameterMatrix(MixtureParameter):
    """f = diag(state[param][state[allocation]]) as a structured Diagonal, one
    per chain: the (..., n) diagonal of each point's component value."""

    def predictor(self, state: dict) -> st.Diagonal:
        vals = state[self.param]
        vals = vals.reshape(vals.shape[:-2] + (-1, 1))
        return st.Diagonal(_gather_components(vals, self.indices(state))[..., 0])

    def grad(self, state: dict, param: str):
        raise TypeError("Not defined in this case")

    def get_grad_param_list(self):
        return []

    def precision_unscaled(self, state: dict, element_index) -> st.Diagonal:
        """Diagonal 0/1 mask of allocation == element_index (the conjugate
        NormalGamma hook)."""
        return st.Diagonal((self.indices(state) == element_index).to(torch.float32))
