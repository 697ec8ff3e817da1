"""Utilities (port of ``openmcmc_tpu/utils``): the host's spans and counters.

``debugging`` (``check_result``, ``nan_debug``) is not ported yet.
"""

from openmcmc_tpu_torch.utils.profiling import count, counters, record, trace_annotated

__all__ = ["count", "counters", "record", "trace_annotated"]
