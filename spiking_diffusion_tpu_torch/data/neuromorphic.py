"""Neuromorphic dataset readers of the port: event-file parsers + dataset
folders, host numpy.

Counterpart of ``spiking_diffusion_tpu/data/neuromorphic.py``, with bitwise
the same results; it rebuilds the reference's ``spikingjelly.zip!datasets/``
stack (file-format parsers, event->frame integration caching, per-dataset
classes) without torchvision. Only ``padded_sequence_mask`` makes a torch
tensor, on the device of the lengths it is given:

* ``load_aedat_v3`` — DAVIS/DVS128 aedat 3.1 (reference
  ``datasets/__init__.py:73-135``). The reference decodes one event per
  Python-loop iteration; this parser decodes each packet's whole payload
  as a numpy view (~1000x fewer interpreter trips).
* ``load_atis_bin`` — 40-bit ATIS events, N-MNIST/N-Caltech101
  (``datasets/__init__.py:137-160``).
* ``load_jaer_dat`` — jAER 2.0 big-endian (addr, t) pairs with
  configurable bit masks, CIFAR10-DVS (``datasets/cifar10_dvs.py:17-107``).
* ``fixed_frames_segment_indices`` / ``integrate_by_fixed_frames`` /
  ``integrate_by_fixed_duration`` — the reference's two integration
  semantics (``datasets/__init__.py:248-415``), vectorized with a single
  scatter-add instead of per-frame bincount loops. Frames are NHWC
  ``(T, H, W, 2)`` — the JAX package's layout, which the port's zoo
  models take at their forward; the reference's ``(T, 2, H, W)``
  is ``frames.transpose(0, 3, 1, 2)``.
* ``EventDatasetFolder`` — the ``NeuromorphicDatasetFolder`` equivalent
  (``datasets/__init__.py:571-838``): walks ``root/events_np/{train,test}/
  <class>/*.npz``, integrates + caches frames under
  ``root/frames_number_{M}_split_by_{s}/`` on first use.
* ``NMNIST`` / ``DVS128Gesture`` / ``CIFAR10DVS`` — per-dataset classes
  with ``create_events_np_files`` converters from the manually-downloaded
  archives' extracted layout, and ``synthesize`` fallbacks that write a
  tiny structurally-identical tree (nothing here downloads; the real-file
  code paths are exercised by packing real binary formats in tests).

Divergences from the reference (both strict improvements, documented):
an empty time bin yields a zero frame (the reference indexes into an
empty array and crashes); conversion is serial (the reference
thread-pools over 8+).

SHD and SSC read HDF5 through ``h5py`` and ASL-DVS reads ``.mat`` files
through ``scipy.io``, each imported on use: the card's machine has no
``h5py``, so SHD and SSC are host-only there.
"""

from __future__ import annotations

import os
import struct
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Events = Dict[str, np.ndarray]

__all__ = [
    "load_aedat_v3",
    "load_atis_bin",
    "load_jaer_dat",
    "fixed_frames_segment_indices",
    "integrate_by_fixed_frames",
    "integrate_by_fixed_duration",
    "EventDatasetFolder",
    "NMNIST",
    "DVS128Gesture",
    "CIFAR10DVS",
    "padded_sequence_mask",
    "pad_sequence_stack",
    "split_to_train_test_set",
    "integrate_1d_by_fixed_frames",
    "SpikingHeidelbergDigits",
    "SpikingSpeechCommands",
    "NCaltech101",
    "ASLDVS",
    "HARDVS",
    "NAVGestureWalk",
    "NAVGestureSit",
    "load_atis_td_dat",
    "ESImageNet",
    "load_es_imagenet_events",
]


# ---------------------------------------------------------------------------
# file-format parsers
# ---------------------------------------------------------------------------

_AEDAT3_HEADER = struct.Struct("<HHIIIIII")


def load_aedat_v3(file_name: str) -> Events:
    """aedat 3.1 -> ``{'t','x','y','p'}`` (DVS128 Gesture recordings).

    Packet stream after the ascii header: 28-byte little-endian packet
    header ``(type, source, size, offset, tsoverflow, capacity, number,
    valid)`` followed by ``capacity * size`` payload bytes; polarity
    packets (type 1) hold ``(aer_data: u32, timestamp: u32)`` records with
    x/y/p bit-packed into ``aer_data``. Parity target:
    ``datasets/__init__.py:73-135`` (same field extraction; payload decoded
    vectorized per packet instead of per event).
    """
    ts, xs, ys, ps = [], [], [], []
    with open(file_name, "rb") as f:
        line = f.readline()
        while line.startswith(b"#"):
            if line == b"#!END-HEADER\r\n":
                break
            line = f.readline()
        while True:
            header = f.read(28)
            if len(header) < 28:
                break
            (e_type, _src, e_size, _off, e_tsoverflow, e_capacity,
             _num, _valid) = _AEDAT3_HEADER.unpack(header)
            data = f.read(e_capacity * e_size)
            if e_type != 1:  # non-polarity packet: skip payload
                continue
            rec = np.frombuffer(
                data, dtype="<u4"
            ).reshape(-1, e_size // 4)
            aer = rec[:, 0]
            ts.append(
                rec[:, 1].astype(np.int64) | (int(e_tsoverflow) << 31)
            )
            xs.append((aer >> 17) & 0x7FFF)
            ys.append((aer >> 2) & 0x7FFF)
            ps.append((aer >> 1) & 1)
    if not ts:
        z = np.zeros((0,), np.int64)
        return {"t": z, "x": z, "y": z, "p": z}
    return {
        "t": np.concatenate(ts),
        "x": np.concatenate(xs).astype(np.int64),
        "y": np.concatenate(ys).astype(np.int64),
        "p": np.concatenate(ps).astype(np.int64),
    }


def load_atis_bin(file_name: str) -> Events:
    """ATIS 40-bit binary -> ``{'t','x','y','p'}`` (N-MNIST samples).

    Per event: byte0 = x, byte1 = y, byte2 bit7 = polarity, bits 22-0 of
    bytes 2-4 = timestamp (us). Parity: ``datasets/__init__.py:137-160``.
    """
    raw = np.fromfile(file_name, dtype=np.uint8).astype(np.uint32)
    raw = raw[: (raw.size // 5) * 5]
    x = raw[0::5]
    y = raw[1::5]
    b2 = raw[2::5]
    p = (b2 & 128) >> 7
    t = ((b2 & 127) << 16) | (raw[3::5] << 8) | raw[4::5]
    return {
        "t": t.astype(np.int64),
        "x": x.astype(np.int64),
        "y": y.astype(np.int64),
        "p": p.astype(np.int64),
    }


def load_jaer_dat(
    file_name: str,
    x_mask: int = 0x003FF000,
    x_shift: int = 12,
    y_mask: int = 0x7FC00000,
    y_shift: int = 22,
    polarity_mask: int = 0x800,
    polarity_shift: Optional[int] = 11,
) -> Events:
    """jAER 2.0 ``.aedat``/``.dat`` -> ``{'t','x','y','p'}``.

    '#'-prefixed ascii header, then big-endian ``(addr: u4, t: u4)``
    pairs; address bit layout is camera-specific (defaults are the DVS128
    layout; CIFAR10-DVS overrides via :class:`CIFAR10DVS`). Parity:
    ``datasets/cifar10_dvs.py:17-107``.
    """
    with open(file_name, "rb") as f:
        skip = 0
        line = f.readline()
        while line.startswith(b"#"):
            skip += len(line)
            line = f.readline()
        f.seek(skip)
        data = np.frombuffer(f.read(), dtype=">u4")
    data = data[: (data.size // 2) * 2]
    addr = data[0::2].astype(np.int64)
    t = data[1::2].astype(np.int64)
    x = (addr & x_mask) >> x_shift
    y = (addr & y_mask) >> y_shift
    p = addr & polarity_mask
    if polarity_shift is not None:
        p >>= polarity_shift
    return {"t": t, "x": x, "y": y, "p": (p != 0).astype(np.int64)}


# ---------------------------------------------------------------------------
# reference-exact integration (vectorized)
# ---------------------------------------------------------------------------

def fixed_frames_segment_indices(
    t: np.ndarray, split_by: str, frames_num: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Segment ``[j_l, j_r)`` per frame — parity with
    ``cal_fixed_frames_number_segment_index``
    (``datasets/__init__.py:248-300``): 'number' packs ``N//M`` events per
    frame, 'time' slices into ``floor(span/M)``-long windows; the last
    frame absorbs the remainder in both. Implemented with searchsorted
    (the t array is time-sorted) instead of the reference's per-frame
    boolean masks; an empty time bin yields ``j_l == j_r`` where the
    reference crashes.
    """
    n = int(t.size)
    if split_by == "number":
        di = n // frames_num
        j_l = np.arange(frames_num, dtype=np.int64) * di
        j_r = j_l + di
        j_r[-1] = n
    elif split_by == "time":
        dt = (int(t[-1]) - int(t[0])) // frames_num
        bounds = int(t[0]) + dt * np.arange(frames_num + 1, dtype=np.int64)
        edges = np.searchsorted(t, bounds, side="left")
        j_l, j_r = edges[:-1], edges[1:].copy()
        j_r[-1] = n
    else:
        raise ValueError(f"split_by must be 'time'|'number', got {split_by!r}")
    return j_l, j_r


def _scatter_frames(
    frame_idx: np.ndarray, events: Events, frames_num: int, H: int, W: int
) -> np.ndarray:
    """One scatter-add for ALL frames: (T, H, W, 2) event counts."""
    frames = np.zeros((frames_num, H, W, 2), np.float32)
    if frame_idx.size:
        x = events["x"].astype(np.int64)
        y = events["y"].astype(np.int64)
        p = events["p"].astype(np.int64)
        np.add.at(frames, (frame_idx, y, x, p), 1.0)
    return frames


def integrate_by_fixed_frames(
    events: Events, split_by: str, frames_num: int, H: int, W: int
) -> np.ndarray:
    """Events -> ``(frames_num, H, W, 2)`` count frames; the reference's
    ``integrate_events_by_fixed_frames_number``
    (``datasets/__init__.py:301-323``) in NHWC with a single scatter-add
    (segments are contiguous, so the per-event frame index is a repeat of
    the segment lengths)."""
    t = np.asarray(events["t"])
    if t.size == 0:
        return np.zeros((frames_num, H, W, 2), np.float32)
    j_l, j_r = fixed_frames_segment_indices(t, split_by, frames_num)
    # segments tile [0, N) contiguously in both modes (j_r[-1] = N), so
    # the per-event frame index is a repeat of the segment lengths
    frame_idx = np.repeat(
        np.arange(frames_num, dtype=np.int64), j_r - j_l
    )
    return _scatter_frames(frame_idx, events, frames_num, H, W)


def integrate_by_fixed_duration(
    events: Events, duration: int, H: int, W: int
) -> np.ndarray:
    """Events -> ``(ceil-ish, H, W, 2)``: greedy fixed-time-window frames,
    parity with ``integrate_events_by_fixed_duration``
    (``datasets/__init__.py:352-389``): each frame spans events with
    ``t - t[left] <= duration`` starting at the previous frame's end."""
    t = np.asarray(events["t"])
    n = int(t.size)
    if n == 0:
        return np.zeros((0, H, W, 2), np.float32)
    lefts = [0]
    while True:
        left = lefts[-1]
        right = int(np.searchsorted(t, int(t[left]) + duration, "right"))
        if right >= n:
            break
        lefts.append(right)
    bounds = np.asarray(lefts + [n], np.int64)
    m = len(lefts)
    frame_idx = np.repeat(
        np.arange(m, dtype=np.int64), bounds[1:] - bounds[:-1]
    )
    return _scatter_frames(frame_idx, events, m, H, W)


def load_atis_td_dat(file_name: str, orig_at_zero: bool = True) -> Events:
    """ATIS ``_td.dat`` (NavGesture phone recordings) -> events.

    '%'-prefixed header lines, then 1-byte event type + 1-byte event size
    (must be 8), then little-endian u64 words: ts in the low 32 bits, x at
    bit 32 (9 bits), y at 41 (8 bits), polarity at 49. Parity:
    ``datasets/nav_gesture.py:12-178`` (``readATIS_tddat``), vectorized;
    the reference's multi-pass negative-dt dropping is equivalent to
    keeping the running-max-monotone subsequence, done here in one pass.
    """
    with open(file_name, "rb") as f:
        header = False
        while True:
            pos = f.tell()
            if f.read(1) != b"%":
                f.seek(pos)
                break
            f.readline()
            header = True
        if header:
            _ev_type = f.read(1)
            ev_size = f.read(1)[0]
            if ev_size != 8:
                raise ValueError(f"unsupported event size {ev_size}")
        data = np.frombuffer(f.read(), dtype="<u8")
    t = (data & 0xFFFFFFFF).astype(np.int64)
    x = ((data & 0x000001FF00000000) >> 32).astype(np.int64)
    y = ((data & 0x0001FE0000000000) >> 41).astype(np.int64)
    p = ((data & 0x0002000000000000) >> 49).astype(np.int64)
    keep = t >= np.maximum.accumulate(t)  # drop negative-dt events
    t, x, y, p = t[keep], x[keep], y[keep], p[keep]
    if orig_at_zero and t.size:
        t = t - t[0]
    return {"t": t, "x": x, "y": y, "p": p}


# ---------------------------------------------------------------------------
# dataset folder
# ---------------------------------------------------------------------------

def _np_load_events(path: str) -> Events:
    with np.load(path) as z:
        return {k: z[k] for k in ("t", "x", "y", "p")}


class EventDatasetFolder:
    """``NeuromorphicDatasetFolder`` equivalent (numpy samples).

    Layout contract (identical to the reference,
    ``datasets/__init__.py:571-838``)::

        root/events_np/{train,test}/<class_name>/<sample>.npz   (t,x,y,p)
        root/frames_number_{M}_split_by_{s}/...                  (cache)
        root/duration_{D}/...                                    (cache)

    ``data_type='event'`` yields raw event dicts; ``'frame'`` integrates
    on first access and caches npz frames next to the events tree, then
    serves from the cache. Samples are ``(sample, label)``;
    ``as_arrays()`` stacks fixed-shape frames into one ``(N, T, H, W, 2)``
    batch for jit-friendly pipelines.
    """

    def __init__(
        self,
        root: str,
        train: bool = True,
        data_type: str = "event",
        frames_number: Optional[int] = None,
        split_by: Optional[str] = None,
        duration: Optional[int] = None,
        custom_integrate_function: Optional[Callable] = None,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
    ) -> None:
        self.H, self.W = self.get_H_W()
        self.transform = transform
        self.target_transform = target_transform
        events_root = os.path.join(root, "events_np")
        if not os.path.isdir(events_root):
            raise FileNotFoundError(
                f"{events_root} not found. Download the archives listed by "
                f"resource_url_md5() into {root}/download, extract into "
                f"{root}/extract, then call create_events_np_files(); or "
                "use .synthesize(root) for a synthetic tree."
            )
        # train=None: no canonical split (N-Caltech101, ASL-DVS) — class
        # folders sit directly under events_np; split with
        # split_to_train_test_set (reference NeuromorphicDatasetFolder
        # passes train=None the same way, ``datasets/__init__.py:828-836``)
        sub = () if train is None else (("train" if train else "test"),)

        def under(base):
            return os.path.join(base, *sub)

        if data_type == "event":
            data_root = under(events_root)
            self._loader: Callable = _np_load_events
        elif data_type == "frame":
            if frames_number is not None:
                if split_by not in ("time", "number"):
                    raise ValueError(
                        "split_by must be 'time'|'number' with frames_number"
                    )
                cache = os.path.join(
                    root, f"frames_number_{frames_number}_split_by_{split_by}"
                )

                def integrate(ev: Events) -> np.ndarray:
                    return integrate_by_fixed_frames(
                        ev, split_by, frames_number, self.H, self.W
                    )
            elif duration is not None:
                cache = os.path.join(root, f"duration_{duration}")

                def integrate(ev: Events) -> np.ndarray:
                    return integrate_by_fixed_duration(
                        ev, duration, self.H, self.W
                    )
            elif custom_integrate_function is not None:
                cache = os.path.join(
                    root, custom_integrate_function.__name__
                )

                def integrate(ev: Events) -> np.ndarray:
                    return custom_integrate_function(ev, self.H, self.W)
            else:
                raise ValueError(
                    "data_type='frame' needs frames_number, duration, or "
                    "custom_integrate_function"
                )
            self._build_frame_cache(
                under(events_root), under(cache), integrate
            )
            data_root = under(cache)

            def _load_frames(path: str) -> np.ndarray:
                with np.load(path) as z:
                    return z["frames"].astype(np.float32)

            self._loader = _load_frames
        else:
            raise ValueError(f"data_type must be 'event'|'frame', got {data_type!r}")

        self.samples: List[Tuple[str, int]] = []
        self.classes = sorted(
            d for d in os.listdir(data_root)
            if os.path.isdir(os.path.join(data_root, d))
        )
        for label, cls in enumerate(self.classes):
            cdir = os.path.join(data_root, cls)
            for fname in sorted(os.listdir(cdir)):
                if fname.endswith(".npz"):
                    self.samples.append((os.path.join(cdir, fname), label))

    @staticmethod
    def _build_frame_cache(
        events_dir: str, cache_dir: str, integrate: Callable
    ) -> None:
        if os.path.isdir(cache_dir):
            return
        for e_root, _dirs, e_files in os.walk(events_dir):
            rel = os.path.relpath(e_root, events_dir)
            out_dir = os.path.join(cache_dir, rel)
            os.makedirs(out_dir, exist_ok=True)
            for e_file in sorted(e_files):
                if not e_file.endswith(".npz"):
                    continue
                frames = integrate(
                    _np_load_events(os.path.join(e_root, e_file))
                )
                np.savez_compressed(
                    os.path.join(out_dir, e_file), frames=frames
                )

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, index: int):
        path, label = self.samples[index]
        sample = self._loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        if self.target_transform is not None:
            label = self.target_transform(label)
        return sample, label

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        """Stack every (fixed-shape) sample: ``(N, ...), (N,)`` labels."""
        xs, ys = zip(*(self[i] for i in range(len(self))))
        return np.stack(xs), np.asarray(ys, np.int64)

    # --- per-dataset hooks (reference's abstract staticmethods) ---
    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        raise NotImplementedError

    @staticmethod
    def resource_url_md5() -> list:
        raise NotImplementedError

    @staticmethod
    def downloadable() -> bool:
        return False


def _save_events(path: str, ev: Events) -> None:
    np.savez_compressed(
        path, t=ev["t"], x=ev["x"], y=ev["y"], p=ev["p"]
    )


def _synthetic_events(
    rng: np.random.RandomState, H: int, W: int, n: int, cls: int, n_cls: int
) -> Events:
    """Class-conditional synthetic stream: a dot sweeping at a
    class-specific angle (temporal structure carries the label)."""
    t = np.sort(rng.randint(0, 1_000_000, n)).astype(np.int64)
    ang = 2 * np.pi * cls / max(n_cls, 1)
    frac = t / 1_000_000.0
    y = np.clip(H / 2 + frac * (H / 3) * np.sin(ang) + rng.randn(n), 0, H - 1)
    x = np.clip(W / 2 + frac * (W / 3) * np.cos(ang) + rng.randn(n), 0, W - 1)
    return {
        "t": t,
        "x": x.astype(np.int64),
        "y": y.astype(np.int64),
        "p": rng.randint(0, 2, n).astype(np.int64),
    }


class NMNIST(EventDatasetFolder):
    """N-MNIST (34x34 ATIS saccade recordings of MNIST digits).

    Parity target: ``datasets/n_mnist.py`` — ``Train.zip``/``Test.zip``
    extract to ``Train/<0..9>/*.bin``; each bin is an ATIS 40-bit stream.
    """

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 34, 34

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://www.garrickorchard.com/datasets/n-mnist"
        return [
            ("Train.zip", url, "20959b8e626244a1b502305a9e6e2031"),
            ("Test.zip", url, "69ca8762b2fe404d9b9bad1103e97832"),
        ]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        return load_atis_bin(file_name)

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """``extract/{Train,Test}/<digit>/*.bin`` ->
        ``events_np/{train,test}/<digit>/*.npz`` (parity:
        ``datasets/n_mnist.py:104-136``; serial — one core here)."""
        for split in ("Train", "Test"):
            src = os.path.join(extract_root, split)
            dst = os.path.join(events_np_root, split.lower())
            for class_name in sorted(os.listdir(src)):
                bin_dir = os.path.join(src, class_name)
                np_dir = os.path.join(dst, class_name)
                os.makedirs(np_dir, exist_ok=True)
                for bin_file in sorted(os.listdir(bin_dir)):
                    out = os.path.splitext(bin_file)[0] + ".npz"
                    _save_events(
                        os.path.join(np_dir, out),
                        cls.load_origin_data(
                            os.path.join(bin_dir, bin_file)
                        ),
                    )

    @classmethod
    def synthesize(
        cls, root: str, per_class: int = 2, n_events: int = 400,
        num_classes: int = 10, seed: int = 0,
    ) -> str:
        """Write a tiny synthetic ``events_np`` tree with the real layout
        (nothing here downloads the archives)."""
        rng = np.random.RandomState(seed)
        H, W = cls.get_H_W()
        for split in ("train", "test"):
            for c in range(num_classes):
                d = os.path.join(root, "events_np", split, str(c))
                os.makedirs(d, exist_ok=True)
                for i in range(per_class):
                    _save_events(
                        os.path.join(d, f"synthetic_{i}.npz"),
                        _synthetic_events(
                            rng, H, W, n_events, c, num_classes
                        ),
                    )
        return root


class DVS128Gesture(EventDatasetFolder):
    """DVS128 Gesture (128x128, 11 classes, aedat 3.1 trial recordings).

    Parity target: ``datasets/dvs128_gesture.py`` — ``DvsGesture.tar.gz``
    extracts to ``DvsGesture/`` holding ``userNN_<light>.aedat`` +
    ``userNN_<light>_labels.csv`` (label, startTime_usec, endTime_usec
    rows) and ``trials_to_train.txt`` / ``trials_to_test.txt``.
    """

    NUM_CLASSES = 11

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 128, 128

    @staticmethod
    def resource_url_md5() -> list:
        url = ("https://ibm.ent.box.com/s/3hiq58ww1pbbjrinh367ykfdf60xsfm8/"
               "folder/50167556794")
        return [
            ("DvsGesture.tar.gz", url, "8a5c71fb11e24e5ca5b11866ca6c00a1"),
            ("gesture_mapping.csv", url, "109b2ae64a0e1f3ef535b18ad7367fd1"),
        ]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        return load_aedat_v3(file_name)

    @classmethod
    def split_aedat_to_np(
        cls, fname: str, aedat_file: str, csv_file: str, output_dir: str
    ) -> None:
        """Slice one trial recording into per-gesture samples by the csv's
        [start, end) windows; labels are csv label minus 1 (parity:
        ``datasets/dvs128_gesture.py:193-227``)."""
        events = cls.load_origin_data(aedat_file)
        csv_data = np.loadtxt(
            csv_file, dtype=np.uint32, delimiter=",", skiprows=1
        ).reshape(-1, 3)
        counts = [0] * cls.NUM_CLASSES
        for label_1, t_start, t_end in csv_data:
            label = int(label_1) - 1
            mask = (events["t"] >= t_start) & (events["t"] < t_end)
            out_dir = os.path.join(output_dir, str(label))
            os.makedirs(out_dir, exist_ok=True)
            _save_events(
                os.path.join(out_dir, f"{fname}_{counts[label]}.npz"),
                {k: events[k][mask] for k in ("t", "x", "y", "p")},
            )
            counts[label] += 1

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        aedat_dir = os.path.join(extract_root, "DvsGesture")
        for trials, split in (
            ("trials_to_train.txt", "train"),
            ("trials_to_test.txt", "test"),
        ):
            out = os.path.join(events_np_root, split)
            os.makedirs(out, exist_ok=True)
            with open(os.path.join(aedat_dir, trials)) as f:
                for line in f:
                    fname = line.strip()
                    if not fname:
                        continue
                    stem = os.path.splitext(fname)[0]
                    cls.split_aedat_to_np(
                        stem,
                        os.path.join(aedat_dir, fname),
                        os.path.join(aedat_dir, stem + "_labels.csv"),
                        out,
                    )

    @classmethod
    def synthesize(
        cls, root: str, per_class: int = 1, n_events: int = 600, seed: int = 0
    ) -> str:
        rng = np.random.RandomState(seed)
        H, W = cls.get_H_W()
        for split in ("train", "test"):
            for c in range(cls.NUM_CLASSES):
                d = os.path.join(root, "events_np", split, str(c))
                os.makedirs(d, exist_ok=True)
                for i in range(per_class):
                    _save_events(
                        os.path.join(d, f"user{i:02d}_synthetic_{c}.npz"),
                        _synthetic_events(
                            rng, H, W, n_events, c, cls.NUM_CLASSES
                        ),
                    )
        return root


class CIFAR10DVS(EventDatasetFolder):
    """CIFAR10-DVS (128x128 jAER recordings of CIFAR-10 images).

    Parity target: ``datasets/cifar10_dvs.py`` — per-class zips extract to
    ``<class_name>/*.aedat`` in jAER 2.0 format with the DVS128 7-bit
    address layout; the reference applies the events-tfds coordinate fix
    ``x' = 127 - y, y' = 127 - x, p' = 1 - p``
    (``datasets/cifar10_dvs.py:186-196``), replicated here.
    """

    CLASS_NAMES = (
        "airplane", "automobile", "bird", "cat", "deer",
        "dog", "frog", "horse", "ship", "truck",
    )

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 128, 128

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://figshare.com/articles/dataset/CIFAR10-DVS_New/4724671"
        return [(f"{c}.zip", url, "") for c in CIFAR10DVS.CLASS_NAMES]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        ev = load_jaer_dat(
            file_name,
            x_mask=0xFE, x_shift=1,
            y_mask=0x7F00, y_shift=8,
            polarity_mask=1, polarity_shift=None,
        )
        return {
            "t": ev["t"],
            "x": 127 - ev["y"],
            "y": 127 - ev["x"],
            "p": 1 - ev["p"],
        }

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str, train_ratio: float = 0.9
    ) -> None:
        """Per-class ``*.aedat`` -> events_np train/test split (the origin
        dataset has no canonical split; the reference leaves splitting to
        ``split_to_train_test_set`` — here the first ``train_ratio`` of
        each class's sorted files go to train, deterministic)."""
        for class_name in sorted(os.listdir(extract_root)):
            src = os.path.join(extract_root, class_name)
            if not os.path.isdir(src):
                continue
            files = sorted(
                f for f in os.listdir(src) if f.endswith((".aedat", ".dat"))
            )
            n_train = int(len(files) * train_ratio)
            for i, fname in enumerate(files):
                split = "train" if i < n_train else "test"
                out_dir = os.path.join(events_np_root, split, class_name)
                os.makedirs(out_dir, exist_ok=True)
                _save_events(
                    os.path.join(
                        out_dir, os.path.splitext(fname)[0] + ".npz"
                    ),
                    cls.load_origin_data(os.path.join(src, fname)),
                )

    @classmethod
    def synthesize(
        cls, root: str, per_class: int = 1, n_events: int = 600, seed: int = 0
    ) -> str:
        rng = np.random.RandomState(seed)
        H, W = cls.get_H_W()
        for split in ("train", "test"):
            for c, name in enumerate(cls.CLASS_NAMES):
                d = os.path.join(root, "events_np", split, name)
                os.makedirs(d, exist_ok=True)
                for i in range(per_class):
                    _save_events(
                        os.path.join(d, f"cifar10_{name}_{i}.npz"),
                        _synthetic_events(rng, H, W, n_events, c, 10),
                    )
        return root


# ---------------------------------------------------------------------------
# batching utilities (reference datasets/__init__.py:476-569)
# ---------------------------------------------------------------------------

def pad_sequence_stack(
    seqs: Sequence[np.ndarray],
) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad variable-length ``(T_i, ...)`` samples to one
    ``(N, T_max, ...)`` batch + ``(N,)`` true lengths — the reference's
    ``pad_sequence_collate`` in numpy."""
    lens = np.asarray([s.shape[0] for s in seqs], np.int64)
    t_max = int(lens.max())
    out = np.zeros((len(seqs), t_max) + tuple(seqs[0].shape[1:]),
                   seqs[0].dtype)
    for i, s in enumerate(seqs):
        out[i, : s.shape[0]] = s
    return out, lens


def padded_sequence_mask(sequence_len, T: Optional[int] = None):
    """``(N,)`` lengths -> ``(T, N)`` bool validity mask (True where
    ``t < len_n``) — the reference's CUDA ``padded_sequence_mask`` kernel
    (``datasets/__init__.py:515-569``) as one comparison on the lengths'
    device (a torch tensor there; numpy or a list on the CPU)."""
    import torch

    sequence_len = torch.as_tensor(sequence_len)
    if T is None:
        T = int(sequence_len.max())
    return torch.arange(T, device=sequence_len.device)[:, None] < sequence_len[None, :]


def split_to_train_test_set(
    train_ratio: float,
    labels: np.ndarray,
    num_classes: int,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class index split (reference ``split_to_train_test_set``,
    ``datasets/__init__.py:438-474``): first ``train_ratio`` of each
    class's sample indices -> train, rest -> test; optional shuffle."""
    rng = np.random.RandomState(seed) if seed is not None else None
    train_idx, test_idx = [], []
    for c in range(num_classes):
        idx = np.nonzero(np.asarray(labels) == c)[0]
        if rng is not None:
            idx = rng.permutation(idx)
        pos = int(len(idx) * train_ratio)
        train_idx.append(idx[:pos])
        test_idx.append(idx[pos:])
    return np.concatenate(train_idx), np.concatenate(test_idx)


# ---------------------------------------------------------------------------
# Spiking Heidelberg Digits / Spiking Speech Commands (1-D audio spikes)
# (reference ``datasets/shd.py``, 848 LoC — HDF5 schema:
#  spikes/times (float seconds), spikes/units (0..W-1), labels)
# ---------------------------------------------------------------------------

def integrate_1d_by_fixed_frames(
    events: Events, split_by: str, frames_num: int, W: int
) -> np.ndarray:
    """1-D events -> ``(frames_num, W)`` count frames. Parity with
    ``cal_fixed_frames_number_segment_index_shd`` +
    ``integrate_events_segment_to_frame_shd`` (``datasets/shd.py:15-63``):
    unlike the 2-D integrator, the SHD 'time' split uses FLOAT dt (times
    are seconds), and there is no polarity channel."""
    t = np.asarray(events["t"])
    x = np.asarray(events["x"], np.int64)
    n = int(t.size)
    frames = np.zeros((frames_num, W), np.float32)
    if n == 0:
        return frames
    if split_by == "number":
        di = n // frames_num
        j_l = np.arange(frames_num, dtype=np.int64) * di
        j_r = j_l + di
        j_r[-1] = n
    elif split_by == "time":
        dt = (float(t[-1]) - float(t[0])) / frames_num
        bounds = float(t[0]) + dt * np.arange(frames_num + 1)
        edges = np.searchsorted(t, bounds, side="left")
        j_l, j_r = edges[:-1], edges[1:].copy()
        j_r[-1] = n
    else:
        raise ValueError(f"split_by must be 'time'|'number', got {split_by!r}")
    frame_idx = np.repeat(np.arange(frames_num, dtype=np.int64), j_r - j_l)
    np.add.at(frames, (frame_idx, x), 1.0)
    return frames


class NCaltech101(EventDatasetFolder):
    """N-Caltech101 (180x240 ATIS saccade recordings of Caltech-101).

    Parity target: ``datasets/n_caltech101.py`` — ``Caltech101.zip``
    extracts to ``Caltech101/<class_name>/*.bin`` (same ATIS format as
    N-MNIST); no canonical train/test split (construct with
    ``train=None`` and split by index with
    :func:`split_to_train_test_set`).
    """

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 180, 240

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://www.garrickorchard.com/datasets/n-caltech101"
        return [
            ("Caltech101.zip", url, "66201824eabb0239c7ab992480b50ba3"),
            ("Caltech101_annotations.zip", url,
             "25e64cea645291e368db1e70f214988e"),
        ]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        return load_atis_bin(file_name)

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """``extract/Caltech101/<class>/*.bin`` ->
        ``events_np/<class>/*.npz`` (no split;
        ``datasets/n_caltech101.py:103-135``)."""
        src_root = os.path.join(extract_root, "Caltech101")
        for class_name in sorted(os.listdir(src_root)):
            bin_dir = os.path.join(src_root, class_name)
            if not os.path.isdir(bin_dir):
                continue
            np_dir = os.path.join(events_np_root, class_name)
            os.makedirs(np_dir, exist_ok=True)
            for bin_file in sorted(os.listdir(bin_dir)):
                out = os.path.splitext(bin_file)[0] + ".npz"
                _save_events(
                    os.path.join(np_dir, out),
                    cls.load_origin_data(os.path.join(bin_dir, bin_file)),
                )

    @classmethod
    def synthesize(
        cls, root: str, classes: Sequence[str] = ("airplanes", "faces"),
        per_class: int = 2, n_events: int = 400, seed: int = 0,
    ) -> str:
        rng = np.random.RandomState(seed)
        H, W = cls.get_H_W()
        for c, name in enumerate(classes):
            d = os.path.join(root, "events_np", name)
            os.makedirs(d, exist_ok=True)
            for i in range(per_class):
                _save_events(
                    os.path.join(d, f"image_{i:04d}.npz"),
                    _synthetic_events(rng, H, W, n_events, c, len(classes)),
                )
        return root


class ASLDVS(EventDatasetFolder):
    """ASL-DVS (180x240 DVS recordings of American Sign Language letters,
    24 classes, stored as MATLAB ``.mat`` files).

    Parity target: ``datasets/asl_dvs.py`` — each sample is a .mat with
    ``ts/x/y/pol`` arrays; the reference flips coordinates
    (``x' = 239 - x``, ``y' = 179 - y``, ``asl_dvs.py:88-94``), replicated
    here. No canonical split (``train=None``).
    """

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 180, 240

    @staticmethod
    def resource_url_md5() -> list:
        url = ("https://www.dropbox.com/sh/ibq0jsicatn7l6r/"
               "AACNrNELV56rs1YInMWUs9CAa")
        return [("ICCV2019_DVS_dataset.zip", url,
                 "8b46191acfd1c3c96ad58f00086842b6")]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        import scipy.io

        m = scipy.io.loadmat(file_name)
        return {
            "t": np.asarray(m["ts"]).squeeze().astype(np.int64),
            "x": 239 - np.asarray(m["x"]).squeeze().astype(np.int64),
            "y": 179 - np.asarray(m["y"]).squeeze().astype(np.int64),
            "p": np.asarray(m["pol"]).squeeze().astype(np.int64),
        }

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """``extract/<class>/*.mat`` -> ``events_np/<class>/*.npz``."""
        for class_name in sorted(os.listdir(extract_root)):
            mat_dir = os.path.join(extract_root, class_name)
            if not os.path.isdir(mat_dir):
                continue
            np_dir = os.path.join(events_np_root, class_name)
            os.makedirs(np_dir, exist_ok=True)
            for mat_file in sorted(os.listdir(mat_dir)):
                if not mat_file.endswith(".mat"):
                    continue
                out = os.path.splitext(mat_file)[0] + ".npz"
                _save_events(
                    os.path.join(np_dir, out),
                    cls.load_origin_data(os.path.join(mat_dir, mat_file)),
                )


class HARDVS(EventDatasetFolder):
    """HARDVS (260x346 DVS human-activity recordings, 300 action classes,
    samples already stored as npz event files).

    Parity target: ``datasets/hardvs.py`` — ``MINI_HARDVS_files.zip``
    extracts to ``action_NNN/dvSave-*.npz``; ``{train,val,test}_label.txt``
    list ``action_NNN/<sample>`` lines assigning samples to splits.
    ``train`` accepts True / False / 'val'.
    """

    NUM_CLASSES = 300

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 260, 346

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://github.com/Event-AHU/HARDVS"
        return [
            ("MINI_HARDVS_files.zip", url,
             "9c4cc0d9ba043faa17f6f1a9e9aff982"),
            ("test_label.txt", url, "5b664af5843f9b476a9c22626f7f5a59"),
            ("train_label.txt", url, "0d642b6e6871034f151b2649a89d8d3c"),
            ("val_label.txt", url, "cd2cebcba80e4552102bbacf2b5df812"),
        ]

    def __init__(self, root: str, train=True, **kw) -> None:
        # map the extra 'val' split onto the folder layout the converter
        # writes (events_np/{train,val,test}/action_NNN/)
        if train == "val":
            events_root = os.path.join(root, "events_np", "val")
            if not os.path.isdir(events_root):
                raise FileNotFoundError(events_root)
            # EventDatasetFolder has no third split slot; point a
            # synthetic root at it via the train=None (splitless) mode
            val_root = os.path.join(root, "_val_view")
            link = os.path.join(val_root, "events_np")
            if not os.path.isdir(link):
                os.makedirs(val_root, exist_ok=True)
                os.symlink(events_root, link)
            super().__init__(val_root, train=None, **kw)
        else:
            super().__init__(root, train=train, **kw)

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """Symlink the per-sample npz files into split/class folders per
        the label lists (``datasets/hardvs.py:90-111``)."""
        for prefix in ("train", "val", "test"):
            target_dir = os.path.join(events_np_root, prefix)
            os.makedirs(target_dir, exist_ok=True)
            with open(
                os.path.join(extract_root, f"{prefix}_label.txt")
            ) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    class_name, sample = line.split(" ")[0].split("/")
                    os.makedirs(
                        os.path.join(target_dir, class_name), exist_ok=True
                    )
                    src = os.path.join(
                        extract_root, class_name, sample + ".npz"
                    )
                    dst = os.path.join(
                        target_dir, class_name, sample + ".npz"
                    )
                    if not os.path.exists(dst):
                        os.symlink(src, dst)


class NAVGestureWalk(EventDatasetFolder):
    """NavGesture-walk (240x304 ATIS phone recordings, 6 gesture classes:
    le/ri/up/do/ho/se). Parity target ``datasets/nav_gesture.py:180-306``:
    samples are ``user_<label>_*.dat`` files sorted into class folders by
    the label token; no canonical split (``train=None``). The y axis is
    flipped (``y' = 239 - y``) as the reference does.
    """

    LABELS = ("do", "ho", "le", "ri", "se", "up")

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 240, 304  # camera is 240x320 but x.max() == 303

    @staticmethod
    def resource_url_md5() -> list:
        url = ("https://www.neuromorphic-vision.com/public/downloads/"
               "navgesture/")
        return [("navgesture-walk.zip", url,
                 "5d305266f13005401959e819abe206f0")]

    @staticmethod
    def load_origin_data(file_name: str) -> Events:
        ev = load_atis_td_dat(file_name)
        return {"t": ev["t"], "x": ev["x"], "y": 239 - ev["y"],
                "p": ev["p"]}

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """``extract/<user>/user_<label>_*.dat`` ->
        ``events_np/<label>/*.npz`` (``nav_gesture.py:276-306``)."""
        for label in cls.LABELS:
            os.makedirs(
                os.path.join(events_np_root, label), exist_ok=True
            )
        for user in sorted(os.listdir(extract_root)):
            udir = os.path.join(extract_root, user)
            if not os.path.isdir(udir):
                continue
            for fname in sorted(os.listdir(udir)):
                if not fname.endswith(".dat"):
                    continue
                base = os.path.splitext(fname)[0]
                label = base.split("_")[1]
                _save_events(
                    os.path.join(events_np_root, label, base + ".npz"),
                    cls.load_origin_data(os.path.join(udir, fname)),
                )


class NAVGestureSit(NAVGestureWalk):
    """NavGesture-sit — same format/classes, seated recordings
    (``datasets/nav_gesture.py:307-339``)."""

    @staticmethod
    def resource_url_md5() -> list:
        url = ("https://www.neuromorphic-vision.com/public/downloads/"
               "navgesture/")
        return [("navgesture-sit.zip", url,
                 "1571753ace4d9e0946e6503313712c22")]


def load_es_imagenet_events(fname: str) -> Events:
    """ES-ImageNet per-sample npz (``pos``/``neg`` arrays of (y, x, t)
    rows) -> merged, time-sorted events (``datasets/es_imagenet.py:9-23``)."""
    with np.load(fname) as z:
        e_pos, e_neg = z["pos"], z["neg"]
    pos = np.hstack([e_pos, np.ones((e_pos.shape[0], 1))])
    neg = np.hstack([e_neg, np.zeros((e_neg.shape[0], 1))])
    ev = np.vstack([pos, neg])
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    return {
        "x": ev[:, 1].astype(np.int64),
        "y": ev[:, 0].astype(np.int64),
        "t": ev[:, 2].astype(np.int64),
        "p": ev[:, 3].astype(np.int64),
    }


class ESImageNet(EventDatasetFolder):
    """ES-ImageNet (256x256 event-converted ImageNet, ~1.3M samples).

    Parity target ``datasets/es_imagenet.py``: samples ship as npz files
    with ``pos``/``neg`` (y, x, t) event lists; the converter symlinks the
    extracted class tree into ``events_np/{train,test}``. The event loader
    merges polarities and time-sorts (:func:`load_es_imagenet_events`).
    """

    @staticmethod
    def get_H_W() -> Tuple[int, int]:
        return 256, 256

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://cloud.tsinghua.edu.cn/d/94873ab4ec2a4eb497b3/"
        return [(f"ES-imagenet-0.18.part{i:02d}.rar", url, "") for i in
                range(1, 11)]

    def __init__(self, root: str, train: bool = True, **kw) -> None:
        super().__init__(root, train=train, **kw)
        if kw.get("data_type", "event") == "event":
            self._loader = load_es_imagenet_events

    @classmethod
    def create_events_np_files(
        cls, extract_root: str, events_np_root: str
    ) -> None:
        """Symlink ``extract/ES-imagenet-0.18/{train,val}`` class trees to
        ``events_np/{train,test}`` (``es_imagenet.py:170-194``)."""
        for src_split, dst_split in (("train", "train"), ("val", "test")):
            src_root = os.path.join(
                extract_root, "ES-imagenet-0.18", src_split
            )
            if not os.path.isdir(src_root):
                continue
            dst_root = os.path.join(events_np_root, dst_split)
            for class_dir in sorted(os.listdir(src_root)):
                sdir = os.path.join(src_root, class_dir)
                ddir = os.path.join(dst_root, class_dir)
                os.makedirs(ddir, exist_ok=True)
                for sample in sorted(os.listdir(sdir)):
                    dst = os.path.join(ddir, sample)
                    if not os.path.exists(dst):
                        os.symlink(os.path.join(sdir, sample), dst)


class SpikingHeidelbergDigits:
    """SHD: 700-channel cochlea spike trains of spoken digits, 20 classes
    (English+German 0-9). Parity target ``datasets/shd.py:122-463``.

    Layout: ``root/extract/shd_train.h5`` / ``shd_test.h5`` (download the
    zips from zenkelab.org and extract; or ``synthesize(root)`` writes
    tiny fake h5 files with the real schema). ``data_type='event'`` yields
    ``{'t','x'}`` dicts; ``'frame'`` integrates with
    :func:`integrate_1d_by_fixed_frames` and caches npz per sample.
    """

    H5_SPLITS = {"train": "shd_train.h5", "test": "shd_test.h5"}
    NUM_CLASSES = 20
    W = 700

    def __init__(
        self,
        root: str,
        train: bool = True,
        data_type: str = "event",
        frames_number: Optional[int] = None,
        split_by: Optional[str] = None,
        transform: Optional[Callable] = None,
        target_transform: Optional[Callable] = None,
    ) -> None:
        import h5py

        # train accepts True/False or a split name ('valid' for SSC)
        split = train if isinstance(train, str) else (
            "train" if train else "test"
        )
        if split not in self.H5_SPLITS:
            raise ValueError(
                f"unknown split {split!r}; have {sorted(self.H5_SPLITS)}"
            )
        h5_path = os.path.join(root, "extract", self.H5_SPLITS[split])
        if not os.path.exists(h5_path):
            raise FileNotFoundError(
                f"{h5_path} not found; download "
                f"{self.H5_SPLITS[split]}.zip from zenkelab.org into "
                f"{root}/download and extract, or use .synthesize(root)."
            )
        self.transform = transform
        self.target_transform = target_transform
        self.data_type = data_type
        self._h5 = h5py.File(h5_path, "r")
        self.labels = np.asarray(self._h5["labels"], np.int64)
        if data_type == "frame":
            if frames_number is None or split_by not in ("time", "number"):
                raise ValueError(
                    "data_type='frame' needs frames_number and "
                    "split_by in {'time','number'}"
                )
            cache = os.path.join(
                root,
                f"frames_number_{frames_number}_split_by_{split_by}",
                split,
            )
            if not os.path.isdir(cache):
                os.makedirs(cache, exist_ok=True)
                times = self._h5["spikes"]["times"]
                units = self._h5["spikes"]["units"]
                for i in range(len(self.labels)):
                    frames = integrate_1d_by_fixed_frames(
                        {"t": times[i], "x": units[i]},
                        split_by, frames_number, self.W,
                    )
                    np.savez_compressed(
                        os.path.join(cache, f"{i}.npz"),
                        frames=frames, label=self.labels[i],
                    )
            self._cache = cache
        elif data_type != "event":
            raise ValueError(
                f"data_type must be 'event'|'frame', got {data_type!r}"
            )

    def __len__(self) -> int:
        return len(self.labels)

    def __getitem__(self, i: int):
        if self.data_type == "event":
            sample = {
                "t": np.asarray(self._h5["spikes"]["times"][i]),
                "x": np.asarray(self._h5["spikes"]["units"][i], np.int64),
            }
        else:
            with np.load(os.path.join(self._cache, f"{i}.npz")) as z:
                sample = z["frames"].astype(np.float32)
        label = int(self.labels[i])
        if self.transform is not None:
            sample = self.transform(sample)
        if self.target_transform is not None:
            label = self.target_transform(label)
        return sample, label

    def as_arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        xs, ys = zip(*(self[i] for i in range(len(self))))
        return np.stack(xs), np.asarray(ys, np.int64)

    @classmethod
    def synthesize(
        cls, root: str, per_class: int = 2, n_events: int = 300, seed: int = 0
    ) -> str:
        """Tiny fake h5 files with the real SHD schema (variable-length
        ragged times/units datasets + labels)."""
        import h5py

        rng = np.random.RandomState(seed)
        os.makedirs(os.path.join(root, "extract"), exist_ok=True)
        for split, fname in cls.H5_SPLITS.items():
            times, units, labels = [], [], []
            for c in range(cls.NUM_CLASSES):
                for _ in range(per_class):
                    n = n_events + rng.randint(-50, 50)
                    t = np.sort(rng.rand(n)).astype(np.float64)
                    center = (c + 0.5) * cls.W / cls.NUM_CLASSES
                    x = np.clip(
                        rng.randn(n) * 40 + center, 0, cls.W - 1
                    ).astype(np.int64)
                    times.append(t)
                    units.append(x)
                    labels.append(c)
            vf = h5py.special_dtype(vlen=np.dtype("float64"))
            vi = h5py.special_dtype(vlen=np.dtype("int64"))
            with h5py.File(
                os.path.join(root, "extract", fname), "w"
            ) as f:
                g = f.create_group("spikes")
                dt_ds = g.create_dataset(
                    "times", (len(times),), dtype=vf
                )
                du_ds = g.create_dataset(
                    "units", (len(units),), dtype=vi
                )
                for i, (t, u) in enumerate(zip(times, units)):
                    dt_ds[i] = t
                    du_ds[i] = u
                f.create_dataset(
                    "labels", data=np.asarray(labels, np.int64)
                )
        return root

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://zenkelab.org/datasets"
        return [
            ("shd_train.h5.zip", url, "f3252aeb598ac776c1b526422d90eecb"),
            ("shd_test.h5.zip", url, "1503a5064faa34311c398fb0a1ed0a6f"),
        ]


class SpikingSpeechCommands(SpikingHeidelbergDigits):
    """SSC: 700-channel spike trains of the Speech Commands words, 35
    classes, with a validation split (``datasets/shd.py:465-848``).
    ``train`` accepts True / False / 'valid'."""

    H5_SPLITS = {
        "train": "ssc_train.h5", "valid": "ssc_valid.h5",
        "test": "ssc_test.h5",
    }
    NUM_CLASSES = 35

    @staticmethod
    def resource_url_md5() -> list:
        url = "https://zenkelab.org/datasets"
        return [
            ("ssc_train.h5.zip", url, "d102be95e7144fcc0553d1f45ba94170"),
            ("ssc_valid.h5.zip", url, "b4eee3516a4a90dd0c71a6ac23a8ae43"),
            ("ssc_test.h5.zip", url, "a35ff1e9cffdd02a20eb850c17c37748"),
        ]
