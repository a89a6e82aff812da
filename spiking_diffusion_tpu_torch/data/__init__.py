"""Data of the port: the MNIST-family IDX readers and the synthetic
fallback, as numpy arrays in host memory (``datasets.py``)."""

from spiking_diffusion_tpu_torch.data.datasets import (
    Dataset,
    batch_iterator,
    data_variance,
    load_dataset,
    synthetic_dataset,
)

__all__ = ["Dataset", "batch_iterator", "data_variance", "load_dataset",
           "synthetic_dataset"]
