"""A window of a fixed number of fits, for the CPU tests' fixed work: once that
many fits of the window have run, the harness's clock jumps past any window,
so the loop ends there. The jump lands in the last fit's wall time, so the
timed metrics of such a run mean nothing."""

import contextlib
import time
import types

JUMP_S = 1e12


@contextlib.contextmanager
def ending_after(harness, workload: str, fits: int, root):
    """Inside the block, ``harness.measure`` of ``workload`` (under ``root``)
    runs exactly ``fits`` fits in its window, given ``seconds`` under
    ``JUMP_S``: the set-up's warm fits, one a dataset of the pool, come first."""
    from openmcmc_tpu_torch.mcmc import MCMC

    traffic = harness.load_cell(root, workload, False).traffic
    warm = int(traffic["datasets"]) if traffic["data"] == "pool" else 1
    calls, jump = [0], [0.0]
    real_run, real_time = MCMC.run, harness.time

    def run(self, *args, **kwargs):
        result = real_run(self, *args, **kwargs)
        calls[0] += 1
        if calls[0] == warm + fits:
            jump[0] = JUMP_S
        return result

    MCMC.run = run
    harness.time = types.SimpleNamespace(perf_counter=lambda: time.perf_counter() + jump[0])
    try:
        yield
    finally:
        MCMC.run, harness.time = real_run, real_time
