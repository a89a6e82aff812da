"""Raw-audio dataset of the port: Google Speech Commands, host numpy;
counterpart of ``spiking_diffusion_tpu/data/audio.py``.

Parity target: ``spikingjelly.zip!datasets/speechcommands.py`` (the one
reference dataset module built on raw waveforms rather than events). The
reference wraps torchaudio; this port reads PCM WAV via scipy and keeps
the reference's split/weighting semantics exactly:

* training list = every ``<label>/<file>.wav`` whose path contains
  ``_nohash_`` and is not under ``_background_noise_``, minus the files
  named in ``validation_list.txt`` and ``testing_list.txt``; the result is
  cached to ``training_list.txt`` (``speechcommands.py:131-160``).
* ``_silence_`` samples are generated dynamically as random crops of the
  ``_background_noise_`` wavs, appended after the walker
  (``speechcommands.py:179-193``).
* per-sample balanced-sampling weights: inverse class frequency, with one
  shared ``1/silence_cnt`` weight for the silence tail
  (``speechcommands.py:160-169``).
* every waveform is peak-normalized (``speechcommands.py:195-197``).

Nothing here downloads — point ``root`` at an extracted
``speech_commands_v0.0x`` directory, or call :meth:`synthesize` to write
a tiny fake tree with the real layout.
"""

from __future__ import annotations

import os
from glob import glob
from typing import Callable, Dict, Optional, Tuple

import numpy as np

HASH_DIVIDER = "_nohash_"
EXCEPT_FOLDER = "_background_noise_"
VAL_RECORD = "validation_list.txt"
TEST_RECORD = "testing_list.txt"
TRAIN_RECORD = "training_list.txt"

#: the reference's download table (speechcommands.py:22-27) — kept for
#: documentation; nothing here downloads.
RESOURCE_MD5 = {
    "speech_commands_v0.01.tar.gz": "3cd23799cb2bbdec517f1cc028f8d43c",
    "speech_commands_v0.02.tar.gz": "6b74f3901214cb2c2934e98196829835",
}


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """(waveform float32 in [-1, 1], sample_rate). PCM int WAVs are scaled
    by their dtype range (torchaudio.load convention)."""
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype.kind == "i":
        data = data.astype(np.float32) / float(-np.iinfo(data.dtype).min)
    elif data.dtype.kind == "u":  # uint8 WAV is offset-binary
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim > 1:  # (n, channels) -> mono
        data = data.mean(axis=1)
    return data, int(sr)


class SpeechCommands:
    """Google Speech Commands over an extracted directory tree.

    ``label_dict`` maps folder names (and optionally ``'_silence_'``) to
    integer class ids, exactly as the reference's constructor argument.
    ``split`` is ``'train' | 'val' | 'test'``.
    """

    def __init__(
        self,
        label_dict: Dict[str, int],
        root: str,
        split: str = "train",
        silence_cnt: int = 0,
        silence_size: int = 16000,
        transform: Optional[Callable] = None,
        seed: int = 0,
    ) -> None:
        if split not in ("train", "val", "test"):
            raise ValueError(f"split must be train|val|test, got {split!r}")
        if silence_cnt < 0:
            raise ValueError(f"Invalid silence_cnt parameter: {silence_cnt}")
        if silence_size <= 0:
            raise ValueError(
                f"Invalid silence_size parameter: {silence_size}"
            )
        if not os.path.isdir(root):
            raise FileNotFoundError(
                f"{root} not found; extract speech_commands_v0.0x there "
                "or use SpeechCommands.synthesize(root)."
            )
        self.label_dict = dict(label_dict)
        self._path = root
        self.split = split
        self.transform = transform
        # silence is dynamic in the reference (global np.random +
        # random.choice); we thread an explicit rng for reproducibility
        self.silence_cnt = silence_cnt if split == "train" else 0
        self.silence_size = silence_size
        self._rng = np.random.default_rng(seed)

        self.noise_list = sorted(
            glob(os.path.join(root, EXCEPT_FOLDER, "*.wav"))
        )
        if self.silence_cnt and not self.noise_list:
            raise FileNotFoundError(
                f"silence_cnt={silence_cnt} needs {EXCEPT_FOLDER}/*.wav"
            )

        if split == "train":
            record = os.path.join(root, TRAIN_RECORD)
            if os.path.exists(record):
                with open(record) as f:
                    self._walker = [ln.rstrip("\n") for ln in f if ln.strip()]
            else:
                walker = sorted(glob(os.path.join(root, "*", "*.wav")))
                walker = [
                    os.path.relpath(w, root).replace(os.sep, "/")
                    for w in walker
                    if HASH_DIVIDER in w and EXCEPT_FOLDER not in w
                ]
                excluded = set()
                for rec in (VAL_RECORD, TEST_RECORD):
                    with open(os.path.join(root, rec)) as f:
                        excluded |= {ln.rstrip("\n") for ln in f if ln.strip()}
                self._walker = [w for w in walker if w not in excluded]
                with open(record, "w") as f:
                    f.write("\n".join(self._walker))

            # balanced-sampling weights (speechcommands.py:160-169)
            labels = [
                self.label_dict[w.split("/")[0]] for w in self._walker
            ]
            label_weights = 1.0 / np.unique(labels, return_counts=True)[1]
            if self.silence_cnt == 0:
                label_weights /= np.sum(label_weights)
                self.weights = np.asarray(
                    [label_weights[lb] for lb in labels], np.float64
                )
            else:
                silence_weight = 1.0 / self.silence_cnt
                total = np.sum(label_weights) + silence_weight
                label_weights /= total
                self.weights = np.asarray(
                    [label_weights[lb] for lb in labels]
                    + [silence_weight / total] * self.silence_cnt,
                    np.float64,
                )
        else:
            rec = VAL_RECORD if split == "val" else TEST_RECORD
            with open(os.path.join(root, rec)) as f:
                self._walker = [ln.rstrip("\n") for ln in f if ln.strip()]
            self.weights = None

    def __len__(self) -> int:
        return len(self._walker) + self.silence_cnt

    def __getitem__(self, n: int) -> Tuple[np.ndarray, int]:
        if n < len(self._walker):
            relpath = self._walker[n]
            label = relpath.split("/")[0]
            waveform, _sr = load_wav(os.path.join(self._path, relpath))
        else:
            noisepath = self.noise_list[
                int(self._rng.integers(len(self.noise_list)))
            ]
            waveform, _sr = load_wav(noisepath)
            offset = int(
                self._rng.integers(len(waveform) - self.silence_size)
            )
            waveform = waveform[offset : offset + self.silence_size]
            label = "_silence_"

        m = np.abs(waveform).max()
        if m > 0:
            waveform = waveform / m
        if self.transform is not None:
            waveform = self.transform(waveform)
        return waveform, self.label_dict[label]

    @classmethod
    def synthesize(
        cls,
        root: str,
        labels: Tuple[str, ...] = ("yes", "no", "stop"),
        per_label: int = 4,
        sr: int = 16000,
        seed: int = 0,
    ) -> str:
        """Write a tiny fake speech_commands tree with the real layout:
        per-label folders of 1 s ``<speaker>_nohash_<k>.wav`` tones,
        ``_background_noise_`` wavs, and validation/testing list files
        (one file of each label per eval split)."""
        from scipy.io import wavfile

        rng = np.random.default_rng(seed)
        os.makedirs(root, exist_ok=True)
        t = np.arange(sr, dtype=np.float32) / sr
        val_lines, test_lines = [], []
        for li, label in enumerate(labels):
            d = os.path.join(root, label)
            os.makedirs(d, exist_ok=True)
            freq = 200.0 * (li + 1)
            for k in range(per_label):
                wave = 0.5 * np.sin(2 * np.pi * freq * t + k)
                wave += 0.05 * rng.standard_normal(sr).astype(np.float32)
                pcm = np.clip(wave * 32767, -32768, 32767).astype(np.int16)
                rel = f"{label}/{rng.integers(1 << 28):08x}_nohash_{k}.wav"
                wavfile.write(os.path.join(root, rel), sr, pcm)
                if k == per_label - 2:
                    val_lines.append(rel)
                elif k == per_label - 1:
                    test_lines.append(rel)
        nd = os.path.join(root, EXCEPT_FOLDER)
        os.makedirs(nd, exist_ok=True)
        for name in ("white_noise.wav", "pink_noise.wav"):
            noise = 0.1 * rng.standard_normal(3 * sr).astype(np.float32)
            pcm = np.clip(noise * 32767, -32768, 32767).astype(np.int16)
            wavfile.write(os.path.join(nd, name), sr, pcm)
        with open(os.path.join(root, VAL_RECORD), "w") as f:
            f.write("\n".join(val_lines))
        with open(os.path.join(root, TEST_RECORD), "w") as f:
            f.write("\n".join(test_lines))
        return root
