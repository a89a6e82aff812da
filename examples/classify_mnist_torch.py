"""Example: spiking image classification with the PyTorch port.

The port's counterpart of ``examples/classify_mnist.py`` (spikingjelly's
``lif_fc_mnist.py`` / ``conv_fashion_mnist.py``): direct-coded input, the
zoo's PLIF net (``models/zoo.PLIFNet``; PLIF is plain PyTorch), AdamW on
the rate-decoded logits through ``zoo.train_classifier``, then the test
accuracy in batches of 256. The weights are drawn from a seed in JAX's
layout (``weights.init_zoo_variables``). On the card unless ``--device
cpu``.

    python examples/classify_mnist_torch.py [--epochs 3] [--data_path DIR]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from spiking_diffusion_tpu_torch.data import load_dataset
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import weights, zoo
from spiking_diffusion_tpu_torch.snn.encoding import direct_encode

SEED = 0


def build_model(channels, num_classes, input_shape, device):
    """PLIFNet on weights drawn from SEED in JAX's layout, in training mode."""
    kw = dict(channels=channels, num_classes=num_classes, input_shape=input_shape)
    variables = weights.init_zoo_variables("plif", torch.Generator().manual_seed(SEED), **kw)
    return weights.load_zoo_model("plif", *variables, device=device, train=True, **kw)


def predict(model, images, num_steps):
    """Class predictions of (N, H, W, C) images, the model in eval mode."""
    model.eval()
    with torch.no_grad():
        return model(direct_encode(images, num_steps)).argmax(-1)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--num_steps", type=int, default=4)
    p.add_argument("--data_path", default=None)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--dataset_name", default="MNIST",
                   help="MNIST | FMNIST | KMNIST | Letters | CIFAR10-BW "
                        "(FMNIST = the conv_fashion_mnist example)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    ds = load_dataset(args.dataset_name, args.data_path)
    print(f"dataset: {ds.name} (synthetic={ds.synthetic})")
    model = build_model(args.channels, ds.num_classes, ds.train_images.shape[1:], dev)
    model, train_acc = zoo.train_classifier(model, ds.train_images, ds.train_labels,
                                            num_steps=args.num_steps, epochs=args.epochs,
                                            log_fn=print, device=dev)
    preds = []
    bs = min(256, len(ds.test_images))
    n_eval = len(ds.test_images) - len(ds.test_images) % bs
    for i in range(0, n_eval, bs):
        x = torch.from_numpy(np.ascontiguousarray(ds.test_images[i:i + bs])).to(dev)
        preds.append(predict(model, x, args.num_steps).cpu().numpy())
    preds = np.concatenate(preds)
    acc = float((preds == ds.test_labels[:len(preds)]).mean())
    print(f"test accuracy: {acc:.4f}")
    return {"train_accuracy": train_acc, "accuracy": acc}


if __name__ == "__main__":
    main()
