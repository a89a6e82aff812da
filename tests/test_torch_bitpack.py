"""The port's spike bit-packing against ``spiking_diffusion_tpu.ops.bitpack``.

The same spikes, made from a seed with numpy, go through JAX's
``pack_spikes`` / ``unpack_spikes`` and the port's: the packed bytes are
bitwise equal, on shapes whose element count is a multiple of 8 and one
that leaves 3 over, and the round trip is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.ops import bitpack as jax_bitpack
from spiking_diffusion_tpu_torch.ops import bitpack

SHAPES = [(16, 2, 7, 7, 8), (7, 7, 3)]  # n % 8 == 0 and n % 8 == 3


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.bool_])
def test_pack_matches_jax_and_round_trips(shape, dtype):
    assert int(np.prod(shape)) % 8 in (0, 3)
    spikes = (np.random.RandomState(0).rand(*shape) < 0.3).astype(dtype)
    want, want_shape = jax_bitpack.pack_spikes(jnp.asarray(spikes))
    got, got_shape = bitpack.pack_spikes(torch.from_numpy(spikes))
    assert got.dtype == torch.uint8 and got.shape == (-(-spikes.size // 8),)
    assert got_shape == tuple(want_shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    back = bitpack.unpack_spikes(got, got_shape)
    assert back.dtype == torch.float32
    np.testing.assert_array_equal(back.numpy(), spikes.astype(np.float32))
    jax_back = jax_bitpack.unpack_spikes(jnp.asarray(got.numpy()), shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jax_back))
    assert bitpack.unpack_spikes(got, got_shape, torch.bool).dtype == torch.bool


def test_full_byte_is_255():
    packed, shape = bitpack.pack_spikes(torch.ones((2, 8)))
    assert packed.tolist() == [255, 255] and shape == (2, 8)
