"""Example: convolutional-SNN keyword spotting on Speech Commands, on the
PyTorch port.

The port's counterpart of ``examples/speechcommands_kws.py``
(spikingjelly's ``activation_based/examples/speechcommands.py``, a
reproduction of arXiv:1911.10124): raw 1 s waveforms (``data/audio.py``)
-> power spectrogram (``scipy.signal.stft``: 30 ms window, 10 ms hop ->
T = 101 frames) -> 40-bin Slaney mel filterbank -> per-mel std rescale, on
the host; then on the device a 3-block dilated Conv2d + LIF net over the
(T, mel) plane whose LIF (``lif_scan``, tau = 10/7, a sigmoid surrogate
of alpha 10) scans the frame axis as SNN time, a linear readout per frame
and the mean over frames. Training: weighted-random sampling of the
silence-augmented train split, Adam and cross-entropy.

The parameters are kept in JAX's layout (HWIO conv kernels, an (in, out)
readout), drawn from a seeded ``torch.Generator``. Without
``--dataset_dir`` a tiny synthetic tree (tone words) is written under the
temporary directory. cuDNN convs and plain PyTorch LIF, on the card
unless ``--device cpu``.

    python examples/speechcommands_kws_torch.py [--epochs 8] [--channels 16]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from spiking_diffusion_tpu_torch.data.audio import SpeechCommands
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.snn.neuron import NeuronParams, lif_scan
from spiking_diffusion_tpu_torch.snn.surrogate import SurrogateFn

SR = 16000
N_FFT = int(30e-3 * SR)  # 480 (speechcommands.py:337)
HOP = int(10e-3 * SR)  # 160
N_MELS = 40
F_MIN, F_MAX = 20.0, 4000.0
SEED = 0

#: the reference's 12-class task: 10 command words + other + silence
#: (``speechcommands.py:68``); the synthetic fallback uses a subset
FULL_LABEL_DICT = {
    "yes": 0, "stop": 1, "no": 2, "right": 3, "up": 4, "left": 5,
    "on": 6, "down": 7, "off": 8, "go": 9, "_silence_": 11,
}


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    return np.where(
        log_region,
        15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0),
        mel,
    )


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    return np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)


def mel_filterbank(n_freqs, n_mels=N_MELS, f_min=F_MIN, f_max=F_MAX, sr=SR):
    """Slaney-normalized triangular filterbank (n_freqs, n_mels) — the
    reference's own ``create_fb_matrix`` (``speechcommands.py:138-176``)."""
    freqs = np.linspace(0, sr / 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel_slaney(f_min), _hz_to_mel_slaney(f_max), n_mels + 2)
    f_pts = _mel_to_hz_slaney(m_pts)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    enorm = 2.0 / (f_pts[2:] - f_pts[:-2])  # slaney area norm
    return (fb * enorm[None, :]).astype(np.float32)


def features(wave: np.ndarray, fb: np.ndarray) -> np.ndarray:
    """1 s waveform -> (T=101, n_mels) rescaled mel power, the reference
    transform chain Pad -> Spectrogram -> MelScale -> Rescale
    (``speechcommands.py:239-256,345-354``)."""
    from scipy.signal import stft

    pad = (SR - len(wave)) // 2
    wave = np.pad(wave, (pad, SR - len(wave) - pad))
    # torchaudio Spectrogram: hann window, center-padded, power=2
    _, _, z = stft(wave, nperseg=N_FFT, noverlap=N_FFT - HOP, boundary="zeros",
                   padded=False, window="hann")
    spec = (np.abs(z) ** 2).astype(np.float32)  # (n_freqs, T)
    mel = spec.T @ fb  # (T, n_mels)
    std = mel.std(axis=0, keepdims=True)  # biased, per mel (Rescale)
    return mel / np.where(std == 0, 1.0, std)


def featurize(ds, idx, fb):
    """A batch of (N, T, M, 1) features, rescaled by the batch's std per mel
    (the collate_fn, ``speechcommands.py:258-266``), and its labels."""
    xs, ys = [], []
    for i in idx:
        w, lb = ds[i]
        xs.append(features(w, fb))
        ys.append(lb)
    x = np.stack(xs)[..., None]
    std = x.std(axis=(0, 1), keepdims=True)
    return (x / np.where(std == 0, 1, std)).astype(np.float32), np.asarray(ys, np.int64)


LIF_P = NeuronParams(tau=10.0 / 7, surrogate=SurrogateFn("sigmoid", 10.0))


def conv_lif(x, w, dilation):
    """Conv2d over the (T, mel) plane, then LIF scanning the frame axis.
    x: (N, C_in, T, M), w: HWIO -> (N, C_out, T', M')."""
    pad_t, pad_m, dil_t, dil_m = dilation
    y = F.conv2d(x, w.permute(3, 2, 0, 1), padding=(pad_t, pad_m), dilation=(dil_t, dil_m))
    s, _ = lif_scan(y.permute(2, 0, 1, 3), params=LIF_P)
    return s.permute(1, 2, 0, 3)


def net_apply(params, x):
    """(N, T, M, 1) -> (N, classes): the reference Net
    (speechcommands.py:298-322): 3 dilated conv + LIF blocks, a per-frame
    linear readout of the (M, C)-ordered features, the mean over T."""
    h = conv_lif(x.permute(0, 3, 1, 2), params["w1"], (2, 1, 1, 1))
    h = conv_lif(h, params["w2"], (6, 3, 4, 3))
    h = conv_lif(h, params["w3"], (24, 9, 16, 9))
    n, t = h.shape[0], h.shape[2]
    h = h.permute(0, 2, 3, 1).reshape(n, t, -1)
    return (h @ params["wf"] + params["bf"]).mean(dim=1)


def init_params(channels, n_mels, n_classes, device, seed=SEED):
    """Unit-normal kernels over sqrt(fan-in), in JAX's layout, trainable."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, fan):
        return torch.randn(shape, generator=gen) / np.sqrt(fan)

    params = {
        "w1": normal((4, 3, 1, channels), 12),
        "w2": normal((4, 3, channels, channels), 12 * channels),
        "w3": normal((4, 3, channels, channels), 12 * channels),
        "wf": normal((channels * n_mels, n_classes), channels * n_mels),
        "bf": torch.zeros((n_classes,)),
    }
    return {k: v.to(device).requires_grad_(True) for k, v in params.items()}


def loss_and_accuracy(params, x, y):
    logits = net_apply(params, x)
    return F.cross_entropy(logits, y), (logits.argmax(-1) == y).float().mean()


def train_step(params, optimizer, x, y):
    """One Adam step: (loss, accuracy)."""
    optimizer.zero_grad(set_to_none=True)
    loss, acc = loss_and_accuracy(params, x, y)
    loss.backward()
    optimizer.step()
    return loss.detach(), acc


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--dataset_dir", default=None,
                   help="extracted speech_commands dir (synthetic if unset)")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--channels", type=int, default=16, help="conv width (reference: 64)")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--silence_cnt", type=int, default=2)
    p.add_argument("--steps_per_epoch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    if args.dataset_dir is None:
        root = os.path.join(tempfile.gettempdir(), "sd_torch_speechcommands")
        labels = ("yes", "no", "stop", "go")
        if not os.path.isdir(root):
            SpeechCommands.synthesize(root, labels=labels, per_label=8)
        label_dict = {lb: i for i, lb in enumerate(labels)}
        label_dict["_silence_"] = len(labels)
        print(f"synthetic dataset at {root}")
    else:
        root = args.dataset_dir
        label_dict = FULL_LABEL_DICT
    n_classes = len(set(label_dict.values()))

    train = SpeechCommands(label_dict, root, "train", silence_cnt=args.silence_cnt)
    test = SpeechCommands(label_dict, root, "test")
    fb = mel_filterbank(N_FFT // 2 + 1)
    params = init_params(args.channels, N_MELS, n_classes, dev)
    optimizer = torch.optim.Adam(params.values(), lr=args.lr, eps=1e-8)

    rng = np.random.default_rng(0)
    w = train.weights / train.weights.sum()
    xt, yt = featurize(test, range(len(test)), fb)
    for epoch in range(args.epochs):
        losses, accs = [], []
        for _ in range(args.steps_per_epoch):
            idx = rng.choice(len(train), size=args.batch_size, p=w)
            x, y = featurize(train, idx, fb)
            loss, acc = train_step(params, optimizer, torch.from_numpy(x).to(dev),
                                   torch.from_numpy(y).to(dev))
            losses.append(float(loss))
            accs.append(float(acc))
        with torch.no_grad():
            preds = net_apply(params, torch.from_numpy(xt).to(dev)).argmax(-1).cpu().numpy()
        test_acc = float((preds == yt).mean())
        print(f"epoch {epoch}: loss {np.mean(losses):.4f} "
              f"train_acc {np.mean(accs):.3f} test_acc {test_acc:.3f}")
    return {"test_accuracy": test_acc, "losses": losses}


if __name__ == "__main__":
    main()
