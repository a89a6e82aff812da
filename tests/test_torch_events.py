"""The port's event integrator (``data/events.py``) and its native C++ loop
(``native/``) against the JAX package's ``data/events.py`` numpy path.

* ``integrate_events_to_frames``: the native loop, the port's plain numpy
  version and JAX's numpy path give the same frames bitwise, in both
  ``split_by`` modes, at several frame counts, on an empty stream and on
  a stream whose time span is 0; a coordinate outside the frame, or
  ('time') an event before t_0, raises on both of the port's routes.
* The native library is built from the port's ``event_ops.cc`` into
  ``build/``, under a name keyed by the source; a failed build raises
  with the compiler's output and never falls back.
* The IDX batch decode and the spike bit-pack, native against plain,
  bitwise; the decode within 1 ulp of JAX's ``/ 255``.
* ``events_to_voxel_grid`` and ``random_temporal_delete`` (the same
  ``RandomState``) bitwise JAX's.
"""

import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.data import events as jax_events
from spiking_diffusion_tpu_torch import native
from spiking_diffusion_tpu_torch.data import events


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _events(n=3000, H=20, W=24, t_max=100_000, seed=0):
    rng = np.random.RandomState(seed)
    return {
        "t": np.sort(rng.randint(0, t_max, n)).astype(np.int64),
        "x": rng.randint(0, W, n).astype(np.int64),
        "y": rng.randint(0, H, n).astype(np.int64),
        "p": rng.randint(0, 2, n).astype(np.int64),
    }


@pytest.mark.parametrize("split_by", ["time", "number"])
@pytest.mark.parametrize("frames", [1, 5, 16])
def test_integrate_native_plain_and_jax_bitwise(split_by, frames):
    ev = _events(seed=frames)
    want = jax_events.integrate_events_to_frames(ev, 20, 24, frames, split_by, use_native=False)
    got_native = events.integrate_events_to_frames(ev, 20, 24, frames, split_by)
    got_plain = events.integrate_events_to_frames(ev, 20, 24, frames, split_by,
                                                  use_native=False)
    for got in (got_native, got_plain):
        assert got.dtype == np.float32 and got.shape == (frames, 20, 24, 2)
        np.testing.assert_array_equal(got, want)
    assert got_native.sum() == len(ev["t"])


@pytest.mark.parametrize("split_by", ["time", "number"])
def test_integrate_edge_streams(split_by):
    empty = {k: np.zeros(0, np.int64) for k in "txyp"}
    flat = _events(n=50)
    flat["t"][:] = 7  # a time span of 0
    for ev in (empty, flat):
        want = jax_events.integrate_events_to_frames(ev, 20, 24, 4, split_by, use_native=False)
        for native_route in (True, False):
            got = events.integrate_events_to_frames(ev, 20, 24, 4, split_by,
                                                    use_native=native_route)
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native_route", [True, False])
def test_integrate_out_of_bounds_raises(native_route):
    for key, value in (("x", 24), ("y", 20), ("x", -1), ("y", -3)):
        ev = _events(n=100)
        ev[key][5] = value
        with pytest.raises(ValueError, match="out of bounds"):
            events.integrate_events_to_frames(ev, 20, 24, 4, use_native=native_route)
    ev = _events(n=100)
    ev["t"][3] = ev["t"][0] - 1  # before t_0: a negative frame
    with pytest.raises(ValueError, match="out of bounds"):
        events.integrate_events_to_frames(ev, 20, 24, 4, "time", use_native=native_route)
    # 'number' bins by position and reads no time
    np.testing.assert_array_equal(
        events.integrate_events_to_frames(ev, 20, 24, 4, "number", use_native=native_route),
        jax_events.integrate_events_to_frames(ev, 20, 24, 4, "number", use_native=False))
    with pytest.raises(ValueError, match="split_by"):
        events.integrate_events_to_frames(_events(n=10), 20, 24, 4, "bins",
                                          use_native=native_route)


def test_native_library_built_into_build_dir():
    native.load()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("event_ops-") and path.suffix == ".so"


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with the compiler's output;
    nothing falls back to numpy."""
    bad = tmp_path / "event_ops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="building event_ops.cc failed") as err:
        native.integrate_events_to_frames(_events(n=10), 20, 24, 2)
    assert "error" in str(err.value)
    assert not any((tmp_path / "build").glob("*.so"))


def test_native_compiler_missing_raises(monkeypatch):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-sdtpu")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.load()


def test_decode_idx_batch_native_plain_and_jax():
    rng = np.random.RandomState(1)
    imgs = rng.randint(0, 256, (40, 28, 28, 1)).astype(np.uint8)
    idx = rng.permutation(40)[:16]
    got = native.decode_idx_batch(imgs, idx)
    assert got.dtype == np.float32 and got.shape == (16, 28, 28, 1)
    np.testing.assert_array_equal(got, native.decode_idx_batch_plain(imgs, idx))
    # JAX's numpy fallback divides by 255: within one ulp of the product
    np.testing.assert_allclose(got, imgs[idx].astype(np.float32) / 255.0, rtol=2 ** -23,
                               atol=0)
    for bad in (np.array([0, 40]), np.array([-1])):
        for fn in (native.decode_idx_batch, native.decode_idx_batch_plain):
            with pytest.raises(IndexError):
                fn(imgs, bad)


@pytest.mark.parametrize("shape", [(13,), (4, 7, 3)])
def test_spike_bitpack_native_and_plain(shape):
    spikes = (np.random.RandomState(2).rand(*shape) > 0.6).astype(np.float32)
    packed = native.pack_spikes(spikes)
    np.testing.assert_array_equal(packed, native.pack_spikes_plain(spikes))
    assert packed.size == (spikes.size + 7) // 8
    for unpack in (native.unpack_spikes, native.unpack_spikes_plain):
        np.testing.assert_array_equal(unpack(packed, shape), spikes)


@pytest.mark.parametrize("bins", [1, 3, 9])
def test_voxel_grid_bitwise(bins):
    ev = _events(n=800, seed=bins)
    got = events.events_to_voxel_grid(ev, 20, 24, bins)
    np.testing.assert_array_equal(got, jax_events.events_to_voxel_grid(ev, 20, 24, bins))
    empty = {k: np.zeros(0, np.int64) for k in "txyp"}
    np.testing.assert_array_equal(events.events_to_voxel_grid(empty, 20, 24, bins),
                                  np.zeros((bins, 20, 24), np.float32))


def test_random_temporal_delete_same_draws():
    frames = np.random.RandomState(3).rand(10, 4, 4, 2).astype(np.float32)
    for keep in (3, 7, 10, 12):
        a, b = np.random.RandomState(keep), np.random.RandomState(keep)
        for _ in range(3):
            np.testing.assert_array_equal(events.random_temporal_delete(frames, keep, a),
                                          jax_events.random_temporal_delete(frames, keep, b))
