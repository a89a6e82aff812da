"""Spiking-neuron primitives of the port: surrogate gradients, neuron
dynamics, encoders, temporal layers and the SNN library around them
(the exports of ``spiking_diffusion_tpu/snn/__init__.py``)."""

from spiking_diffusion_tpu_torch.snn.surrogate import (
    SurrogateFn,
    atan,
    erf,
    get_surrogate,
    heaviside,
    leaky_k_relu,
    piecewise_quadratic,
    sigmoid,
    soft_sign,
    spike_fn,
)
from spiking_diffusion_tpu_torch.snn.neuron import (
    NeuronParams,
    eif_scan,
    if_scan,
    if_step,
    izhikevich_scan,
    lif_multi_step,
    lif_scan,
    lif_step,
    plif_scan,
    qif_scan,
)
from spiking_diffusion_tpu_torch.snn import functional, quantize
from spiking_diffusion_tpu_torch.snn.temporal import (
    membrane_output,
    membrane_output_coef,
    psp,
    seq_apply,
)
from spiking_diffusion_tpu_torch.snn.encoding import (
    direct_encode,
    latency_encode,
    periodic_encode,
    poisson_encode,
    weighted_phase_encode,
)
from spiking_diffusion_tpu_torch.snn import learning, rnn, tempotron

__all__ = [
    "SurrogateFn",
    "atan",
    "erf",
    "get_surrogate",
    "heaviside",
    "leaky_k_relu",
    "piecewise_quadratic",
    "sigmoid",
    "soft_sign",
    "spike_fn",
    "NeuronParams",
    "eif_scan",
    "functional",
    "if_step",
    "izhikevich_scan",
    "lif_multi_step",
    "lif_scan",
    "lif_step",
    "if_scan",
    "plif_scan",
    "qif_scan",
    "quantize",
    "membrane_output",
    "membrane_output_coef",
    "psp",
    "seq_apply",
    "direct_encode",
    "latency_encode",
    "learning",
    "periodic_encode",
    "poisson_encode",
    "rnn",
    "tempotron",
    "weighted_phase_encode",
]
