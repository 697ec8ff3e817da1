"""The benchmark's ESS is the program's ESS, on draws whose ESS lies below the cap."""

import pytest
import torch

from bench_torch.ess import ess_per_column
from openmcmc_tpu_torch.diagnostics import ess_per_param


@pytest.mark.parametrize("shape, phi", [((8, 50, 3), 0.7), ((64, 200, 40), 0.9), ((1, 30, 2), 0.5),
                                        ((16, 101, 5), -0.3), ((32, 64, 70), 0.0)])
def test_ess_equals_the_programs(shape, phi):
    g = torch.Generator().manual_seed(sum(shape))
    x = torch.randn(shape, generator=g)
    for t in range(1, shape[1]):  # AR(1) chains
        x[:, t] = phi * x[:, t - 1] + x[:, t]
    torch.testing.assert_close(ess_per_column(x, chunk=16), ess_per_param(x), rtol=1e-5, atol=1e-4)
