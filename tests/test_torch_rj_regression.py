"""The reversible-jump knot-basis regression (``fused_rj`` with a likelihood)
against its plain reference, ``tests/plain/rj_regression.py``: the program's
log posterior against the plain joint log density (a), its count and tau_y
moments against the plain sampler of the same posterior (b), the plain file's
imports, and the RJ path's ``fused.prepare`` span.

CPU only, at a small size of the fixture's law: n_max 6, n_data 20. The
moment test walks theta and omega with steps 0.5 and 0.3 (the fixture's 0.1
and 0.1 need about ten times the burn-in to forget four random starting knots
at this size) and puts rho at 3, so that the count's posterior lies inside
1..6."""

import importlib.util
import math
import subprocess
import sys
from pathlib import Path

import torch

from openmcmc_tpu_torch.diagnostics import ess_per_param
from openmcmc_tpu_torch.utils import profiling
from torch_models import rj_regression_mcmc

torch.set_num_threads(2)

PLAIN = Path(__file__).resolve().parent / "plain" / "rj_regression.py"
COPY = Path(__file__).resolve().parents[1] / "bench_torch" / "reference" / "rj_regression.py"


def plain():
    """The plain reference, loaded by its path."""
    name = "plain_rj_regression"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, PLAIN)
        module = importlib.util.module_from_spec(spec)
        sys.modules[name] = module
        spec.loader.exec_module(module)
    return sys.modules[name]


def problem(data, n_max, rho):
    X, y = torch.as_tensor(data["X"]), torch.as_tensor(data["y"])
    return plain().Problem(X, y, n_max, rho, -10.0, 10.0, 0.0, 0.25, 3.0, 2.0, 2.0, 0.01)


def stored(res):
    """k, beta, theta, omega and tau_y of every stored draw, and its log posterior."""
    st = res.store
    return (st["n_basis"][..., 0, 0], st["beta"][..., 0], st["theta"][..., 0, :], st["omega"][..., 0, :],
            st["tau_y"][..., 0, 0]), res.log_post


def test_log_post_is_the_plain_log_density():
    """Every stored draw's log posterior equals the plain joint log density of
    the stored state within 5e-5 relative (to max(|lp|, 1)). The program sums
    it in float32 from terms as large as n_data / 2 |log tau_y| (about 50 here),
    which cancel to |lp| of a few: float32's rounding of 6e-8 over some hundred
    operations on such terms reads up to 1.5e-5 absolute (1e-5 relative) over
    these seeds. TF32, the precision below the configuration's, reads about
    5e-2 (``bench_torch``'s control at a small size)."""
    worst = 0.0
    for seed in (3, 4):
        mcmc, data = rj_regression_mcmc(seed, n_chains=64, n_burn=10, n_iter=20)
        res = mcmc.run(engine="auto")
        assert res.engine == "fused_rj"
        state, lp = stored(res)
        want = plain().log_density(problem(data, 6, 8.0), *state)
        assert bool(torch.all(torch.isfinite(want)))
        gap = torch.abs(lp.reshape(-1).double() - want) / torch.clamp(torch.abs(want), min=1.0)
        worst = max(worst, float(gap.max()))
    assert worst < 5e-5, worst


def summary(draws):
    """Mean, variance and their Monte Carlo standard errors of (chains, draws)."""
    x = draws.double()
    mean = x.mean()
    dev2 = (x - mean) ** 2
    var = dev2.mean()
    ess = float(ess_per_param(x[..., None].float(), chunk_size=1)[0])
    ess2 = float(ess_per_param(dev2[..., None].float(), chunk_size=1)[0])
    return float(mean), float(var), math.sqrt(float(var) / ess), float(dev2.std()) / math.sqrt(ess2)


def test_count_and_tau_moments_agree_with_the_plain_sampler():
    """The program's posterior mean and variance of the count and of tau_y
    (64 chains, 200 + 100 sweeps) agree with the plain sampler's (128 chains,
    200 + 300 sweeps, its own moves) within 5 combined Monte Carlo sd (over
    seeds 7 to 12 every |z| read under 3)."""
    mcmc, data = rj_regression_mcmc(7, n_chains=64, n_burn=200, n_iter=100, step_theta=0.5, step_omega=0.3,
                                    rho=3.0, store=("n_basis", "tau_y"))
    res = mcmc.run(engine="auto")
    assert res.engine == "fused_rj"
    got = {"k": res.store["n_basis"][..., 0, 0], "tau": res.store["tau_y"][..., 0, 0]}
    want = plain().sample(problem(data, 6, 3.0), 128, 200, 300, torch.Generator().manual_seed(11))
    for name in ("k", "tau"):
        a, b = summary(got[name]), summary(want[name])
        z_mean = (a[0] - b[0]) / math.hypot(a[2], b[2])
        z_var = (a[1] - b[1]) / math.hypot(a[3], b[3])
        assert abs(z_mean) < 5.0 and abs(z_var) < 5.0, (name, a, b, z_mean, z_var)


def test_the_plain_reference_imports_neither_jax_nor_the_program():
    """The plain file, loaded alone in a fresh process, leaves no module of JAX,
    the JAX package or the program in ``sys.modules``; the benchmark's copy is
    the same file, byte for byte, and both keep TF32 off."""
    script = "\n".join([
        "import importlib.util, sys",
        f"spec = importlib.util.spec_from_file_location('plain_rj', {str(PLAIN)!r})",
        "m = importlib.util.module_from_spec(spec); sys.modules['plain_rj'] = m; spec.loader.exec_module(m)",
        "import torch",
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32",
        "print(sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'openmcmc_tpu', "
        "'openmcmc_tpu_torch')))",
    ])
    got = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.strip() == "[]"
    assert PLAIN.read_bytes() == COPY.read_bytes()


def test_the_rj_path_records_one_prepare_span_a_fit():
    """Inside ``profiling.record()`` each fused RJ fit is one span tree: the
    match, ``fused.prepare`` (the data, the initial rows and the kernel's
    constants), the kernel (its plain version here) and the repackaging."""
    mcmc, _ = rj_regression_mcmc(3, n_chains=8, n_burn=2, n_iter=3)
    with profiling.record() as rec:
        mcmc.run(engine="auto")
        mcmc.seed = 4
        mcmc.run(engine="auto")
    roots = sorted((s for s in rec.spans if s.name == profiling.RUN), key=lambda s: s.t0_ns)
    assert len(roots) == 2
    for root in roots:
        kids = sorted((s for s in rec.spans if s.parent_id == root.span_id), key=lambda s: s.t0_ns)
        assert [s.name for s in kids] == ["mcmc.match", "fused.prepare", "kernel.rj", "mcmc.repackage"]
        assert root.attrs == {"engine": "fused_rj"}
    assert sum(s.name == "fused.prepare" for s in rec.spans) == 2
