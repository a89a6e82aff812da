"""The port's neuromorphic readers (``data/neuromorphic.py``) and event
transforms (``data/transforms.py``) against the JAX package's.

The cases of ``tests/test_neuromorphic.py`` and
``tests/test_event_transforms.py``, each input packed once in the real
binary format (aedat 3.1, ATIS 40-bit, jAER 2.0, ATIS ``_td.dat``,
``.mat``, HDF5, ES-ImageNet npz) and parsed, integrated or walked by both
packages: every event array, frame, label, class list and sample path
equal bitwise, dtypes included. The synthesized trees of every dataset
class hold the same events; the frame cache read again equals the frames
of its first pass; ``pad_sequence_stack``, ``split_to_train_test_set``
and ``padded_sequence_mask`` (a bool torch tensor on the lengths'
device) equal JAX's.
"""

import os
import struct

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.data import neuromorphic as jnm
from spiking_diffusion_tpu.data import transforms as jtf
from spiking_diffusion_tpu_torch.data import neuromorphic as tnm
from spiking_diffusion_tpu_torch.data import transforms as ttf
from tests.test_neuromorphic import _pack_aedat_v3, _rand_events


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _same(a, b):
    """Equal values of the same type: arrays bitwise with their dtype,
    dicts key by key, sequences item by item."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b)


def _same_folder(ds_j, ds_t, root_j, root_t):
    """Two dataset folders of the two packages over twin trees: the same
    classes, the same samples (paths relative to their roots, labels) and
    every item equal."""
    assert ds_j.classes == ds_t.classes and len(ds_j) == len(ds_t)
    rel = lambda ds, root: [(os.path.relpath(p, root), y) for p, y in ds.samples]  # noqa: E731
    assert rel(ds_j, root_j) == rel(ds_t, root_t)
    for i in range(len(ds_j)):
        _same(ds_j[i], ds_t[i])


# --- parsers ---------------------------------------------------------------


def test_aedat_v3_parsers_equal(tmp_path):
    rng = np.random.RandomState(0)
    for i, overflow in enumerate((0, 1)):
        ev = _rand_events(rng, n=300, H=128, W=128)
        path = os.path.join(tmp_path, f"x{i}.aedat")
        blob = _pack_aedat_v3(ev, tsoverflow=overflow)
        hlen = len(b"#!AER-DAT3.1\r\n#!END-HEADER\r\n")
        junk = b""
        if overflow:  # a frame-event packet mid-stream, skipped by both
            junk = struct.pack("<HHIIIIII", 2, 0, 8, 0, 0, 4, 4, 4) + b"\0" * 32
        with open(path, "wb") as f:
            f.write(blob[:hlen] + junk + blob[hlen:])
        _same(jnm.load_aedat_v3(path), tnm.load_aedat_v3(path))
        _same(jnm.DVS128Gesture.load_origin_data(path), tnm.DVS128Gesture.load_origin_data(path))


def test_atis_bin_parsers_equal(tmp_path):
    rng = np.random.RandomState(2)
    ev = _rand_events(rng, n=400, H=34, W=34, t_max=(1 << 23) - 1)
    raw = np.zeros(len(ev["t"]) * 5, np.uint8)
    raw[0::5] = ev["x"]
    raw[1::5] = ev["y"]
    raw[2::5] = (ev["p"] << 7) | ((ev["t"] >> 16) & 0x7F)
    raw[3::5] = (ev["t"] >> 8) & 0xFF
    raw[4::5] = ev["t"] & 0xFF
    path = os.path.join(tmp_path, "x.bin")
    raw.tofile(path)
    _same(jnm.load_atis_bin(path), tnm.load_atis_bin(path))
    _same(jnm.NMNIST.load_origin_data(path), tnm.NMNIST.load_origin_data(path))
    _same(jnm.NCaltech101.load_origin_data(path), tnm.NCaltech101.load_origin_data(path))
    _same(tnm.load_atis_bin(path), ev)


def test_jaer_dat_parsers_equal(tmp_path):
    rng = np.random.RandomState(3)
    ev = _rand_events(rng, n=200, H=128, W=128)
    addr = (ev["x"] << 1) | (ev["y"] << 8) | ev["p"]
    data = np.empty(len(ev["t"]) * 2, dtype=">u4")
    data[0::2] = addr
    data[1::2] = ev["t"]
    path = os.path.join(tmp_path, "x.aedat")
    with open(path, "wb") as f:
        f.write(b"#!AER-DAT2.0\r\n# comment line\r\n")
        f.write(data.tobytes())
    _same(jnm.load_jaer_dat(path), tnm.load_jaer_dat(path))
    _same(jnm.CIFAR10DVS.load_origin_data(path), tnm.CIFAR10DVS.load_origin_data(path))


def test_atis_td_dat_parsers_equal(tmp_path):
    rng = np.random.RandomState(8)
    n = 200
    t = np.sort(rng.randint(1000, 50_000, n)).astype(np.uint64)
    x = rng.randint(0, 304, n).astype(np.uint64)
    y = rng.randint(0, 240, n).astype(np.uint64)
    p = rng.randint(0, 2, n).astype(np.uint64)
    words = t | (x << 32) | (y << 41) | (p << 49)
    words[50] = (np.uint64(10)) | (x[50] << 32) | (y[50] << 41) | (p[50] << 49)
    path = os.path.join(tmp_path, "user01_le_1.dat")
    with open(path, "wb") as f:
        f.write(b"% header line\n% another\n")
        f.write(bytes([0, 8]))
        f.write(words.astype("<u8").tobytes())
    for zero in (True, False):
        _same(jnm.load_atis_td_dat(path, zero), tnm.load_atis_td_dat(path, zero))
    _same(jnm.NAVGestureWalk.load_origin_data(path), tnm.NAVGestureWalk.load_origin_data(path))


def test_es_imagenet_parsers_equal(tmp_path):
    rng = np.random.RandomState(10)
    pos = np.stack([rng.randint(0, 256, 60), rng.randint(0, 256, 60),
                    rng.randint(0, 1000, 60)], axis=1)
    neg = np.stack([rng.randint(0, 256, 40), rng.randint(0, 256, 40),
                    rng.randint(0, 1000, 40)], axis=1)
    path = os.path.join(tmp_path, "sample0.npz")
    np.savez(path, pos=pos, neg=neg)
    _same(jnm.load_es_imagenet_events(path), tnm.load_es_imagenet_events(path))


# --- integrators -----------------------------------------------------------


@pytest.mark.parametrize("split_by", ["time", "number"])
@pytest.mark.parametrize("M", [4, 16])
def test_fixed_frames_equal(split_by, M):
    ev = _rand_events(np.random.RandomState(M), n=700)
    _same(jnm.fixed_frames_segment_indices(ev["t"], split_by, M),
          tnm.fixed_frames_segment_indices(ev["t"], split_by, M))
    _same(jnm.integrate_by_fixed_frames(ev, split_by, M, 34, 34),
          tnm.integrate_by_fixed_frames(ev, split_by, M, 34, 34))


def test_empty_time_bin_zero_frame_equal():
    ev = {"t": np.array([0, 1, 2, 100], np.int64), "x": np.array([0, 1, 2, 3], np.int64),
          "y": np.array([0, 0, 1, 1], np.int64), "p": np.array([0, 1, 0, 1], np.int64)}
    got = tnm.integrate_by_fixed_frames(ev, "time", 8, 7, 5)
    _same(jnm.integrate_by_fixed_frames(ev, "time", 8, 7, 5), got)
    assert got[3].sum() == 0  # an empty bin: a zero frame (the documented divergence)


@pytest.mark.parametrize("duration", [1_000, 5_000, 250_000])
def test_fixed_duration_equal(duration):
    ev = _rand_events(np.random.RandomState(7), n=600, H=16, W=20)
    _same(jnm.integrate_by_fixed_duration(ev, duration, 16, 20),
          tnm.integrate_by_fixed_duration(ev, duration, 16, 20))
    empty = {k: np.zeros(0, np.int64) for k in "txyp"}
    _same(jnm.integrate_by_fixed_duration(empty, duration, 16, 20),
          tnm.integrate_by_fixed_duration(empty, duration, 16, 20))


@pytest.mark.parametrize("split_by", ["time", "number"])
def test_integrate_1d_equal(split_by):
    rng = np.random.RandomState(11)
    ev = {"t": np.sort(rng.rand(3000)), "x": rng.randint(0, 700, 3000).astype(np.int64)}
    _same(jnm.integrate_1d_by_fixed_frames(ev, split_by, 16, 700),
          tnm.integrate_1d_by_fixed_frames(ev, split_by, 16, 700))


# --- dataset folders ---------------------------------------------------------


@pytest.mark.parametrize("name", ["NMNIST", "DVS128Gesture", "CIFAR10DVS", "NCaltech101"])
def test_synthesized_trees_equal(tmp_path, name):
    jcls, tcls = getattr(jnm, name), getattr(tnm, name)
    rj, rt = str(tmp_path / "jax"), str(tmp_path / "torch")
    kw = dict(per_class=1)
    jroot, troot = jcls.synthesize(rj, **kw), tcls.synthesize(rt, **kw)
    train = None if name == "NCaltech101" else True
    _same_folder(jcls(jroot, train=train), tcls(troot, train=train), jroot, troot)


def test_nmnist_frame_cache_equal(tmp_path):
    jroot = jnm.NMNIST.synthesize(str(tmp_path / "jax"), per_class=2, num_classes=3)
    troot = tnm.NMNIST.synthesize(str(tmp_path / "torch"), per_class=2, num_classes=3)
    for train in (True, False):
        kw = dict(train=train, data_type="frame", frames_number=8, split_by="number")
        first = tnm.NMNIST(troot, **kw)
        x1, y1 = first.as_arrays()
        _same_folder(jnm.NMNIST(jroot, **kw), first, jroot, troot)
        x2, y2 = tnm.NMNIST(troot, **kw).as_arrays()  # from the cache
        _same((x1, y1), (x2, y2))
        events = tnm.NMNIST(troot, train=train)
        for i in range(len(events)):
            _same(tnm.integrate_by_fixed_frames(events[i][0], "number", 8, 34, 34), x1[i])
    assert os.path.isdir(os.path.join(troot, "frames_number_8_split_by_number", "test"))


def test_folder_duration_and_custom_equal(tmp_path):
    jroot = jnm.NMNIST.synthesize(str(tmp_path / "jax"), per_class=1, num_classes=2, seed=3)
    troot = tnm.NMNIST.synthesize(str(tmp_path / "torch"), per_class=1, num_classes=2, seed=3)
    kw = dict(train=True, data_type="frame", duration=200_000)
    _same_folder(jnm.NMNIST(jroot, **kw), tnm.NMNIST(troot, **kw), jroot, troot)

    def halves(ev, H, W):
        return tnm.integrate_by_fixed_frames(ev, "number", 2, H, W)

    kw = dict(train=True, data_type="frame", custom_integrate_function=halves)
    _same_folder(jnm.NMNIST(jroot, **kw), tnm.NMNIST(troot, **kw), jroot, troot)
    with pytest.raises(FileNotFoundError):
        tnm.NMNIST(str(tmp_path / "none"), train=True)
    with pytest.raises(ValueError, match="split_by"):
        tnm.NMNIST(troot, train=True, data_type="frame", frames_number=2, split_by="x")


def test_dvs128_trial_split_equal(tmp_path):
    rng = np.random.RandomState(5)
    extract = os.path.join(tmp_path, "extract")
    ad = os.path.join(extract, "DvsGesture")
    os.makedirs(ad)
    for split, stem in (("train", "user01_led"), ("test", "user02_led")):
        with open(os.path.join(ad, f"trials_to_{split}.txt"), "w") as f:
            f.write(stem + ".aedat\n")
        with open(os.path.join(ad, stem + ".aedat"), "wb") as f:
            f.write(_pack_aedat_v3(_rand_events(rng, n=600, H=128, W=128, t_max=90_000)))
        with open(os.path.join(ad, stem + "_labels.csv"), "w") as f:
            f.write("class,startTime_usec,endTime_usec\n1,0,30000\n2,30000,60000\n"
                    "2,60000,90001\n")
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jnm.DVS128Gesture.create_events_np_files(extract, os.path.join(jroot, "events_np"))
    tnm.DVS128Gesture.create_events_np_files(extract, os.path.join(troot, "events_np"))
    for train in (True, False):
        _same_folder(jnm.DVS128Gesture(jroot, train=train),
                     tnm.DVS128Gesture(troot, train=train), jroot, troot)
    kw = dict(train=True, data_type="frame", frames_number=4, split_by="time")
    _same_folder(jnm.DVS128Gesture(jroot, **kw), tnm.DVS128Gesture(troot, **kw), jroot, troot)


def test_asl_dvs_mat_equal(tmp_path):
    scipy_io = pytest.importorskip("scipy.io")
    ev = _rand_events(np.random.RandomState(4), n=150, H=180, W=240)
    extract = os.path.join(tmp_path, "extract")
    os.makedirs(os.path.join(extract, "a"))
    scipy_io.savemat(os.path.join(extract, "a", "a_0001.mat"),
                     {"ts": ev["t"], "x": 239 - ev["x"], "y": 179 - ev["y"],
                      "p_unused": 0, "pol": ev["p"]})
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jnm.ASLDVS.create_events_np_files(extract, os.path.join(jroot, "events_np"))
    tnm.ASLDVS.create_events_np_files(extract, os.path.join(troot, "events_np"))
    _same_folder(jnm.ASLDVS(jroot, train=None), tnm.ASLDVS(troot, train=None), jroot, troot)


def test_hardvs_label_files_equal(tmp_path):
    rng = np.random.RandomState(6)
    extract = os.path.join(tmp_path, "extract")
    lines = {"train": [], "val": [], "test": []}
    for c in (1, 2):
        cdir = os.path.join(extract, f"action_{c:03d}")
        os.makedirs(cdir)
        for i, split in enumerate(("train", "val", "test")):
            name = f"dvSave-sample{i}"
            np.savez(os.path.join(cdir, name + ".npz"), **_rand_events(rng, n=50, H=260, W=346))
            lines[split].append(f"action_{c:03d}/{name} {c}")
    for split, ls in lines.items():
        with open(os.path.join(extract, f"{split}_label.txt"), "w") as f:
            f.write("\n".join(ls) + "\n")
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    jnm.HARDVS.create_events_np_files(extract, os.path.join(jroot, "events_np"))
    tnm.HARDVS.create_events_np_files(extract, os.path.join(troot, "events_np"))
    for train in (True, False, "val"):
        _same_folder(jnm.HARDVS(jroot, train=train), tnm.HARDVS(troot, train=train),
                     jroot, troot)


def test_navgesture_folder_equal(tmp_path):
    rng = np.random.RandomState(9)
    extract = os.path.join(tmp_path, "extract")
    for user in ("user01", "user02"):
        udir = os.path.join(extract, user)
        os.makedirs(udir)
        for label in ("le", "up"):
            n = 100
            t = np.sort(rng.randint(0, 10_000, n)).astype(np.uint64)
            x = rng.randint(0, 304, n).astype(np.uint64)
            y = rng.randint(0, 240, n).astype(np.uint64)
            p = rng.randint(0, 2, n).astype(np.uint64)
            words = (t | (x << 32) | (y << 41) | (p << 49)).astype("<u8")
            with open(os.path.join(udir, f"{user}_{label}_0.dat"), "wb") as f:
                f.write(b"% h\n" + bytes([0, 8]) + words.tobytes())
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    for name in ("NAVGestureWalk", "NAVGestureSit"):
        getattr(jnm, name).create_events_np_files(extract, os.path.join(jroot, name, "events_np"))
        getattr(tnm, name).create_events_np_files(extract, os.path.join(troot, name, "events_np"))
        _same_folder(getattr(jnm, name)(os.path.join(jroot, name), train=None),
                     getattr(tnm, name)(os.path.join(troot, name), train=None), jroot, troot)


def test_es_imagenet_folder_equal(tmp_path):
    rng = np.random.RandomState(10)
    extract = os.path.join(tmp_path, "extract", "ES-imagenet-0.18")
    for split in ("train", "val"):
        cdir = os.path.join(extract, split, "n01440764")
        os.makedirs(cdir)
        pos = np.stack([rng.randint(0, 256, 60), rng.randint(0, 256, 60),
                        rng.randint(0, 1000, 60)], axis=1)
        neg = np.stack([rng.randint(0, 256, 40), rng.randint(0, 256, 40),
                        rng.randint(0, 1000, 40)], axis=1)
        np.savez(os.path.join(cdir, "sample0.npz"), pos=pos, neg=neg)
    jroot, troot = str(tmp_path / "jax"), str(tmp_path / "torch")
    src = os.path.join(tmp_path, "extract")
    jnm.ESImageNet.create_events_np_files(src, os.path.join(jroot, "events_np"))
    tnm.ESImageNet.create_events_np_files(src, os.path.join(troot, "events_np"))
    for train in (True, False):
        _same_folder(jnm.ESImageNet(jroot, train=train), tnm.ESImageNet(troot, train=train),
                     jroot, troot)


def test_shd_and_ssc_equal(tmp_path):
    pytest.importorskip("h5py")
    for name, kw, splits in (("SpikingHeidelbergDigits", {}, (True, False)),
                             ("SpikingSpeechCommands", {}, (True, False, "valid"))):
        jcls, tcls = getattr(jnm, name), getattr(tnm, name)
        jroot = jcls.synthesize(str(tmp_path / "jax" / name), per_class=1, n_events=100)
        troot = tcls.synthesize(str(tmp_path / "torch" / name), per_class=1, n_events=100)
        for train in splits:
            for mode in ({}, dict(data_type="frame", frames_number=8, split_by="number"),
                         dict(data_type="frame", frames_number=4, split_by="time")):
                dj, dt = jcls(jroot, train=train, **mode), tcls(troot, train=train, **mode)
                assert len(dj) == len(dt)
                for i in range(len(dj)):
                    _same(dj[i], dt[i])


# --- batching utilities ------------------------------------------------------


def test_pad_sequence_stack_equal():
    rng = np.random.RandomState(12)
    seqs = [rng.rand(n, 2, 3).astype(np.float32) for n in (3, 5, 1, 4)]
    _same(jnm.pad_sequence_stack(seqs), tnm.pad_sequence_stack(seqs))


@pytest.mark.parametrize("T", [None, 5, 9])
def test_padded_sequence_mask_equal(T):
    lens = np.array([3, 5, 1, 0, 4])
    want = np.asarray(jnm.padded_sequence_mask(lens, T=T))
    for given in (lens, torch.from_numpy(lens), lens.tolist()):
        got = tnm.padded_sequence_mask(given, T=T)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
        assert got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [None, 0, 3])
def test_split_to_train_test_set_equal(seed):
    labels = np.random.RandomState(13).randint(0, 3, 40)
    _same(jnm.split_to_train_test_set(0.6, labels, 3, seed),
          tnm.split_to_train_test_set(0.6, labels, 3, seed))


# --- transforms --------------------------------------------------------------


def test_transforms_equal():
    ev = _rand_events(np.random.RandomState(14), n=1000, H=16, W=16, t_max=50_000)
    for fn, args in (("slice_by_time_bins", (4,)), ("slice_by_time_bins", (3, 0.25)),
                     ("slice_by_event_count", (5,)), ("slice_by_event_count", (40, 15, True))):
        _same(getattr(jtf, fn)(ev, *args), getattr(ttf, fn)(ev, *args))
    frames = tnm.integrate_by_fixed_frames(ev, "number", 16, 16, 16)
    _same(jtf.to_bina_rep(frames > 0, 2, 8), ttf.to_bina_rep(frames > 0, 2, 8))
    for make, args in (("to_frame", (16, 16, 4)), ("to_frame", (16, 16, 4, "time")),
                       ("to_voxel_grid", (16, 16, 5)), ("to_image", (16, 16))):
        _same(getattr(jtf, make)(*args)(ev), getattr(ttf, make)(*args)(ev))
    pipe_j = jtf.Compose([jtf.to_frame(16, 16, 8), lambda f: jtf.to_bina_rep(f > 0, 2, 4)])
    pipe_t = ttf.Compose([ttf.to_frame(16, 16, 8), lambda f: ttf.to_bina_rep(f > 0, 2, 4)])
    _same(pipe_j(ev), pipe_t(ev))
