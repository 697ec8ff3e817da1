"""openmcmc_tpu_torch: the PyTorch and CUDA port of openmcmc_tpu.

The port mirrors the JAX package's module tree. What it covers so far is the
GMRF smoother family: the model layer, the generic driver, ``MCMC.run(engine=
"auto")`` with the fused-engine dispatch to the spectral smoother
(``csrc/spectral_smoother.cu``) and the Thomas-scan smoother with its
box-truncated variant (``csrc/gmrf_smoother.cu``), the in-kernel Philox
random-number layer (``csrc/philox.cuh``, ``csrc/prng.cuh``), and multi-chain
diagnostics; and Bayesian linear regression: ``LinearCombination`` means, the
generic driver's dense conjugate step, and the fused engines with an unrolled
Cholesky (``csrc/linreg.cu``, p <= 16) and in eigencoordinates
(``csrc/spectral_linreg.cu``, p <= 256); and the Metropolis family: the
distributions' gradients and negative Hessians, ``RandomWalk``,
``RandomWalkLoop`` and ``ManifoldMALA`` in the generic driver, and the fused
engines for random-walk Metropolis (``csrc/random_walk.cu``) and constant-metric
manifold MALA (``csrc/mmala.cu``, p <= 16; ``csrc/spectral_mmala.cu``,
p <= 256); and the Gaussian mixture: the mixture parameter forms,
``Categorical``, ``MixtureAllocation`` and the mixture branches of the conjugate
samplers in the generic driver, and the fused mixture engine
(``csrc/mixture.cu``). Everything off those paths raises
``NotImplementedError`` naming its ROADMAP.md item.

Importing the package sets the full-fp32 matmul invariant once: no TF32 anywhere,
matching the JAX package's ``Precision.HIGHEST`` pinning.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# The CPU path's first float32 torch.log in a process has been seen to come back
# up to 4e-5 off on some of its elements while other processes load the CPUs
# (MKL-backed builds); every later call was exact. Take that first call here,
# on a tensor large enough to be split across threads, so that no draw does.
torch.log(torch.linspace(0.5, 2.0, 1 << 16))

from openmcmc_tpu_torch import (  # noqa: E402
    convert,
    diagnostics,
    distributions,
    fused,
    linalg,
    parameters,
    samplers,
)
from openmcmc_tpu_torch.mcmc import MCMC, MCMCResult  # noqa: E402
from openmcmc_tpu_torch.model import Model  # noqa: E402

__all__ = [
    "MCMC",
    "MCMCResult",
    "Model",
    "convert",
    "diagnostics",
    "distributions",
    "fused",
    "linalg",
    "parameters",
    "samplers",
]
