"""Data of the port: the MNIST-family IDX readers and the synthetic
fallback (``datasets.py``); CIFAR10(-BW), CelebA, MNIST-square, notMNIST
and MNIST-C (``extra_datasets.py``); the event-camera readers and
integrators (``events.py``, ``neuromorphic.py``, ``transforms.py``) and
Speech Commands (``audio.py``). All are numpy arrays in host memory; the
event integrator's hot loop is the C++ of ``native/``."""

from spiking_diffusion_tpu_torch.data.datasets import (
    Dataset,
    batch_iterator,
    data_variance,
    load_dataset,
    synthetic_dataset,
)
from spiking_diffusion_tpu_torch.data.extra_datasets import (
    load_celeba,
    load_cifar10,
    load_mnist_c,
    load_notmnist,
    mnist_square,
)
from spiking_diffusion_tpu_torch.data.audio import SpeechCommands, load_wav
from spiking_diffusion_tpu_torch.data.neuromorphic import (
    CIFAR10DVS,
    DVS128Gesture,
    EventDatasetFolder,
    NMNIST,
    integrate_by_fixed_duration,
    integrate_by_fixed_frames,
    load_aedat_v3,
    load_atis_bin,
    load_jaer_dat,
)

__all__ = ["Dataset", "batch_iterator", "data_variance", "load_dataset",
           "synthetic_dataset", "load_celeba", "load_cifar10", "load_mnist_c",
           "load_notmnist", "mnist_square", "CIFAR10DVS", "DVS128Gesture",
           "EventDatasetFolder", "NMNIST", "integrate_by_fixed_duration",
           "integrate_by_fixed_frames", "load_aedat_v3", "load_atis_bin",
           "load_jaer_dat", "SpeechCommands", "load_wav"]
