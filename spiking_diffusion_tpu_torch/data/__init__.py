"""Data of the port: the MNIST-family IDX readers and the synthetic
fallback (``datasets.py``), and CIFAR10(-BW), CelebA, MNIST-square,
notMNIST and MNIST-C (``extra_datasets.py``), as numpy arrays in host
memory."""

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

__all__ = ["Dataset", "batch_iterator", "data_variance", "load_dataset",
           "synthetic_dataset", "load_celeba", "load_cifar10", "load_mnist_c",
           "load_notmnist", "mnist_square"]
