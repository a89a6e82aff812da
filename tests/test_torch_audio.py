"""The port's Speech Commands reader (``data/audio.py``) against the JAX
package's, on a synthesized tree with the real layout (PCM16 WAVs, the
split lists, ``_background_noise_``).

Both packages synthesize the same tree from one seed (every WAV's bytes
and the list files equal); over it the training list, the training-list
cache, the validation and test splits, every waveform and label, the
silence tail's crops (the same seeded draws) and the balanced-sampling
weights equal JAX's bitwise; ``load_wav`` reads every PCM width alike.
"""

import os

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.data import audio as jaudio
from spiking_diffusion_tpu_torch.data import audio as taudio

LABELS = ("yes", "no", "stop")
LABEL_DICT = {lb: i for i, lb in enumerate(LABELS)}
LABEL_DICT["_silence_"] = len(LABELS)


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("speech_commands")
    jroot = jaudio.SpeechCommands.synthesize(str(base / "jax"), labels=LABELS, per_label=4)
    troot = taudio.SpeechCommands.synthesize(str(base / "torch"), labels=LABELS, per_label=4)
    return jroot, troot


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthesized_trees_equal(roots):
    jroot, troot = roots
    names = [n for n in _files(jroot) if n != taudio.TRAIN_RECORD]
    assert names == [n for n in _files(troot) if n != taudio.TRAIN_RECORD]
    for name in names:
        with open(os.path.join(jroot, name), "rb") as a, open(os.path.join(troot, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("silence", [0, 3])
def test_split_waveforms_and_weights_equal(roots, split, silence):
    jroot, troot = roots
    kw = dict(silence_cnt=silence, silence_size=800, seed=5)
    dj = jaudio.SpeechCommands(LABEL_DICT, jroot, split, **kw)
    dt = taudio.SpeechCommands(LABEL_DICT, troot, split, **kw)
    assert dj._walker == dt._walker and len(dj) == len(dt)
    if split == "train":
        assert dt.weights.dtype == np.float64
        np.testing.assert_array_equal(dj.weights, dt.weights)
        with open(os.path.join(troot, taudio.TRAIN_RECORD)) as f:
            assert f.read().split("\n") == dt._walker
    else:
        assert dj.weights is None and dt.weights is None
    for i in range(len(dj)):
        (wj, lj), (wt, lt) = dj[i], dt[i]
        assert lj == lt and wj.dtype == wt.dtype == np.float32
        np.testing.assert_array_equal(wj, wt)


def test_load_wav_and_transform_equal(roots, tmp_path):
    from scipy.io import wavfile

    jroot, troot = roots
    first = jaudio.SpeechCommands(LABEL_DICT, jroot, "test")._walker[0]
    (wj, sj), (wt, st) = (jaudio.load_wav(os.path.join(jroot, first)),
                          taudio.load_wav(os.path.join(troot, first)))
    assert sj == st == 16000
    np.testing.assert_array_equal(wj, wt)
    rng = np.random.RandomState(0)
    for dtype, data in (("int16", rng.randint(-32768, 32767, 500)),
                        ("int32", rng.randint(-2 ** 31, 2 ** 31 - 1, (500, 2))),
                        ("uint8", rng.randint(0, 255, 500)),
                        ("float32", rng.rand(500) * 2 - 1)):
        path = str(tmp_path / f"{dtype}.wav")
        wavfile.write(path, 8000, data.astype(dtype))
        (wj, sj), (wt, st) = jaudio.load_wav(path), taudio.load_wav(path)
        assert sj == st == 8000 and wt.dtype == wj.dtype and wt.shape == wj.shape
        np.testing.assert_array_equal(wj, wt)
    ds = taudio.SpeechCommands(LABEL_DICT, troot, "test", transform=lambda w: w[:100])
    assert ds[0][0].shape == (100,)


def test_bad_arguments_raise(roots, tmp_path):
    _, troot = roots
    for kw in (dict(split="dev"), dict(silence_cnt=-1), dict(silence_size=0)):
        with pytest.raises(ValueError):
            taudio.SpeechCommands(LABEL_DICT, troot, **kw)
    with pytest.raises(FileNotFoundError):
        taudio.SpeechCommands(LABEL_DICT, str(tmp_path / "none"))
