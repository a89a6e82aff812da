"""Each package of the port exports the JAX package's public names.

For every subpackage, each name in the JAX package's ``__all__`` is in the
port's ``__all__`` and importable from it, or is listed below: found
elsewhere in the port (where the port names it), or with no counterpart
and why.
"""

import importlib

import pytest

SUBPACKAGES = ("", ".data", ".metrics", ".models", ".ops", ".parallel", ".profiling", ".snn",
               ".train", ".utils")

# JAX name -> where the port has it
ELSEWHERE = {
    ".ops": {"lif_fused": "spiking_diffusion_tpu_torch.ops.lif:lif"},  # K1
}
# JAX name -> why the port has none
NO_COUNTERPART = {
    ".models": {
        "torch_kernel_init": "flax initialisers of PyTorch's law: nn.Linear / nn.Conv2d have it",
        "torch_bias_init": "flax initialisers of PyTorch's law: nn.Linear / nn.Conv2d have it",
    },
    ".ops": {"lif_unrolled": "ops/unrolled_lif.py, an XLA unrolling of K1 (no counterpart)"},
    ".parallel": {
        "batch_sharding": "a jax.sharding.NamedSharding; the port's ranks slice with shard_batch",
        "replicated_sharding": "a jax.sharding.NamedSharding; the port replicates with replicate",
        "shard_map_compat": "jax.experimental.shard_map across versions; one process per rank",
    },
}


@pytest.mark.parametrize("sub", SUBPACKAGES, ids=[s or "top" for s in SUBPACKAGES])
def test_all_matches_jax(sub):
    jax_pkg = importlib.import_module("spiking_diffusion_tpu" + sub)
    port = importlib.import_module("spiking_diffusion_tpu_torch" + sub)
    elsewhere, none = ELSEWHERE.get(sub, {}), NO_COUNTERPART.get(sub, {})
    exported = set(getattr(port, "__all__", ()))
    for name in exported:
        assert hasattr(port, name), f"{port.__name__}.__all__ names {name!r}, which it lacks"
    missing = []
    for name in jax_pkg.__all__:
        if name in none:
            continue
        if name in elsewhere:
            module, attr = elsewhere[name].split(":")
            assert hasattr(importlib.import_module(module), attr), elsewhere[name]
            continue
        if name not in exported:
            missing.append(name)
    assert not missing, f"{port.__name__} does not export {missing}"
    # the lists name only what JAX exports
    assert set(elsewhere) | set(none) <= set(jax_pkg.__all__)
