"""Example: export a spiking classifier of the PyTorch port to the Lynxi
exchange format and run inference from the exported files alone.

The port's counterpart of ``examples/lynxi_infer.py`` (spikingjelly's
``lynxi_fmnist_inference.py``): a ``SpikingVGG((8, "M", 16, "M"))``
trains briefly on FashionMNIST (its synthetic stand-in without the IDX
files) with ``zoo.train_classifier``, each LIF layer on K1 forward and
backward on the card; ``models.deploy.export_lynxi`` writes it in the
Lynxi vocabulary (T folded into the batch, torch weight layouts); then
``lynxi_reference_forward`` executes the manifest and npz alone on the
same device, and its decisions must be the in-framework model's on
held-out data.

    python examples/lynxi_infer_torch.py [--epochs 2] [--device cpu]

Runs on the card unless ``--device cpu`` is passed, with TF32 off (a
TF32 conv can flip a spike at the threshold).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np
import torch

from spiking_diffusion_tpu_torch.data import load_dataset
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import deploy, weights, zoo

CFG = (8, "M", 16, "M")
CLASSES = 10
BATCH = 64


def run(epochs: int = 2, n_train: int = 512, n_test: int = 128, T: int = 4,
        data_path: str = "./data",
        out: str = os.path.join(tempfile.gettempdir(), "lynxi_export", "fmnist_vgg"),
        device="cuda") -> dict:
    """Train, export, execute the export and compare; the figures, with
    the training steps taken (``steps``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    ds = load_dataset("FMNIST", data_path, synthetic_ok=True)
    x_train = ds.train_images[:n_train].reshape(-1, 28, 28, 1)
    y_train = ds.train_labels[:n_train].astype(np.int32)
    x_test = ds.test_images[:n_test].reshape(-1, 28, 28, 1)
    y_test = ds.test_labels[:n_test].astype(np.int32)

    kw = dict(cfg=CFG, num_classes=CLASSES, input_shape=(28, 28, 1))
    variables = weights.init_zoo_variables("vgg", torch.Generator().manual_seed(0), **kw)
    model = weights.load_zoo_model("vgg", *variables, device=dev, train=True, **kw)
    model, train_acc = zoo.train_classifier(model, x_train, y_train, num_steps=T,
                                            epochs=epochs, batch_size=BATCH, device=dev)

    layers = deploy.lynxi_layers_from_vgg(CFG, num_classes=CLASSES)
    json_path, npz_path = deploy.export_lynxi(layers, weights.zoo_variables(model), out, T=T)

    x_seq = torch.from_numpy(np.ascontiguousarray(x_test)).to(dev)
    x_seq = x_seq[None].expand((T,) + tuple(x_seq.shape))
    with torch.no_grad():
        logits_fw = model.eval()(x_seq)
    # the exchange format: T folded into the batch, the rate decode here
    logits_lx = deploy.lynxi_reference_forward(
        json_path, npz_path, x_seq.reshape((-1,) + x_test.shape[1:]), device=dev)
    logits_lx = logits_lx.reshape(T, len(x_test), CLASSES).mean(0)
    return {
        "train_accuracy": train_acc,
        "steps": epochs * (n_train // BATCH),
        "agreement": float((logits_fw.argmax(-1) == logits_lx.argmax(-1)).float().mean()),
        "max_abs_logit_diff": float((logits_fw - logits_lx).abs().max()),
        "test_accuracy": float((logits_lx.argmax(-1).cpu().numpy() == y_test).mean()),
        "json": json_path, "npz": npz_path,
    }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_test", type=int, default=128)
    p.add_argument("--T", type=int, default=4)
    p.add_argument("--data_path", default="./data")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "lynxi_export",
                                                 "fmnist_vgg"))
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    res = run(args.epochs, args.n_train, args.n_test, args.T, args.data_path, args.out,
              args.device)
    print(f"train accuracy after {args.epochs} epochs: {res['train_accuracy']:.3f}")
    print(f"exported {res['json']} + {res['npz']}")
    print(f"framework-vs-export argmax agreement: {res['agreement']:.4f} "
          f"(max |logit diff| {res['max_abs_logit_diff']:.2e})")
    print(f"exported-model test accuracy: {res['test_accuracy']:.3f} (chance 0.10)")
    if res["agreement"] != 1.0:
        raise SystemExit("the export must reproduce the framework's decisions")


if __name__ == "__main__":
    main()
