"""Profiling of the port: spike-aware op/energy accounting, monitors and
the timing harness; counterpart of ``spiking_diffusion_tpu/profiling``.

``syops`` counts each layer's ACs and MACs with forward hooks for one
call (free unless a call is profiled), ``monitor`` captures outputs,
spike rates, membrane traces, gradient norms and the card's memory, and
``benchmark`` / ``trace`` time a function on CUDA events and trace it
with ``torch.profiler``.
"""

from spiking_diffusion_tpu_torch.profiling import monitor, syops
from spiking_diffusion_tpu_torch.profiling.timing import benchmark, trace

__all__ = ["syops", "monitor", "benchmark", "trace"]
