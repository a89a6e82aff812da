"""The port's op/energy profiler (``profiling/syops.py``) against the JAX
package's ``profiling/syops.py``.

The same numpy inputs and weights go through both. The JAX side runs its
LIF layers through the scan oracle and its Pallas kernels (the fused
BN-apply + LIF, the training conv) in interpret mode; its variables are
stripped to ``params`` and ``batch_stats``, as its CLI passes them (the
tree from ``init`` carries a ``syops`` collection, to which ``sow`` would
append a second entry per layer). The port's kernels take their plain
versions on the CPU.

* ``spike_stats``, ``classify`` and ``neuron_entry`` equal JAX's, in fp32
  and bf16.
* ``profile_apply``: the same keys, ``ops`` and ``macs`` exactly equal,
  ``acs`` and ``rate`` within rtol 1e-6 (the frameworks round a mean in
  another way), the totals within rtol 1e-6: the tiny VQ-VAE forward on
  'auto', 'bnlif' and 'bnlif_torch', its ``decode_indices``, the tiny
  denoiser on 'auto', 'bnlif' and 'bnlifconv', and the committed
  full-width e60 VQ-VAE and denoiser at batch 2, with ``count_params``
  equal to JAX's.
* ``format_report`` is JAX's string; ``profile_dataset`` averages as
  JAX's, an empty loader included; ``probe_energy`` on JAX's own codes and
  probes is within rtol 1e-5 of JAX's ``generation_energy``.
* ``profile_apply`` leaves no hook of its own and every module's mode.
* The committed JAX record (``profiling/assets/syops_e60_jax.json``,
  ``scripts/syops_jax_record.py``) regenerates unchanged.
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.ops import spike_conv as jax_spike_conv
from spiking_diffusion_tpu.profiling import syops as jax_syops
from spiking_diffusion_tpu.train.checkpoint import load_variables
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.models.layers import LIF
from spiking_diffusion_tpu_torch.profiling import syops

RTOL = 1e-6
ENERGY_RTOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "result_r5_e60", "MNIST", "snn-vq-vae")
RECORD_SCRIPT = os.path.join(REPO, "scripts", "syops_jax_record.py")
VQ_KW = dict(num_steps=4, embedding_dim=4, num_embeddings=12, enc_channels=(4, 8),
             dec_channels=(8, 4))
DEN_KW = dict(num_timesteps=8, denoiser_channels=(6, 10), num_embeddings=12, mask_id=12,
              num_steps=4)
# the port's branch -> the JAX package's backend for it
JAX_BACKEND = {"auto": "scan", "bnlif": "bnlif", "bnlif_torch": "bnlif",
               "bnlifconv": "bnlifconv"}


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = jax_spike_conv._INTERPRET, jax_bn_lif._INTERPRET
    jax_spike_conv._INTERPRET = jax_bn_lif._INTERPRET = True
    yield
    jax_spike_conv._INTERPRET, jax_bn_lif._INTERPRET = old


def _strip(variables):
    """``params`` and ``batch_stats`` as numpy, as the JAX CLI passes them."""
    return {k: jax.tree_util.tree_map(np.asarray, variables[k])
            for k in ("params", "batch_stats")}


def _firing(variables, seed):
    """BN's scale and shift drawn so that every LIF layer fires: scale in
    [2, 5], shift in [0.5, 1.5] per channel."""
    rs = np.random.RandomState(seed)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if "BatchNorm_0" in path and path[-1] in ("scale", "bias"):
            lo, hi = (2.0, 5.0) if path[-1] == "scale" else (0.5, 1.5)
            return rs.uniform(lo, hi, node.shape).astype(np.float32)
        return node

    return {**variables, "params": walk(variables["params"], ())}


@pytest.fixture(scope="module")
def tiny():
    """(VQ-VAE variables, denoiser variables, images, codes, tokens, t)."""
    rs = np.random.RandomState(0)
    images = (rs.uniform(0, 1, (2, 28, 28, 1)) - 0.5).astype(np.float32)
    vq_init = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan").init
    vq_vars = jax.jit(lambda k, x: vq_init(k, x, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(images))
    tokens = rs.randint(0, DEN_KW["num_embeddings"] + 1, (3, 7, 7)).astype(np.int32)
    t = np.asarray([1, 4, 8], np.int32)
    den_init = JaxDenoiser(JaxDiffusionConfig(**DEN_KW), backend="scan").init
    den_vars = jax.jit(lambda k, x, t: den_init(k, x, t, train=True))(
        jax.random.PRNGKey(2), jnp.asarray(tokens), jnp.asarray(t))
    codes = rs.randint(0, VQ_KW["num_embeddings"], (3, 7, 7)).astype(np.int32)
    return (_firing(_strip(vq_vars), 3), _firing(_strip(den_vars), 4), images, codes,
            tokens, t)


def _vqvae(variables, cfg, backend="auto"):
    return weights.load_vqvae(variables["params"], variables["batch_stats"], cfg,
                              device="cpu", lif_backend=backend)


def _denoiser(variables, cfg, backend="auto"):
    return weights.load_denoiser(variables["params"], variables["batch_stats"], cfg,
                                 device="cpu", lif_backend=backend)


def _jax_profile(model, variables, *args, **kwargs):
    _, per_layer, total = jax_syops.profile_apply(
        model, variables, *[jnp.asarray(a) for a in args], **kwargs)
    return per_layer, total


def assert_profiles_equal(per_layer, total, per_layer_j, total_j):
    assert list(per_layer) == list(per_layer_j)
    for key, entry in per_layer.items():
        want = per_layer_j[key]
        assert entry["ops"] == want["ops"] and entry["macs"] == want["macs"], key
        np.testing.assert_allclose([entry["acs"], entry["rate"]], [want["acs"], want["rate"]],
                                   rtol=RTOL, atol=0, err_msg=key)
    assert set(total) == set(total_j)
    for key in total:
        np.testing.assert_allclose(total[key], total_j[key], rtol=RTOL, atol=0, err_msg=key)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_counters_equal_jax(dtype):
    rs = np.random.RandomState(5)
    spikes = rs.binomial(1, 0.3, (4, 6, 5)).astype(np.float32)
    analog = rs.normal(0, 1, (4, 6, 5)).astype(np.float32)
    cast = {"float32": (jnp.float32, torch.float32),
            "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]

    def both(x):
        return jnp.asarray(x).astype(cast[0]), torch.from_numpy(x).to(cast[1])

    def host(entry):
        return {k: float(np.asarray(v)) for k, v in entry.items()}

    for x in (spikes, analog, np.zeros_like(spikes)):
        xj, xt = both(x)
        is_spike_j, rate_j = jax_syops.spike_stats(xj)
        is_spike, rate = syops.spike_stats(xt)
        assert bool(is_spike) == bool(is_spike_j)
        assert rate.dtype == torch.float32 and float(rate) == float(rate_j)
        # 2**24 + 1 rounds to 2**24 in fp32, as jnp.float32 rounds it
        for ops in (100.0, 2.0 ** 24 + 1, 3.7e9):
            ours, theirs = syops.classify(ops, xt), jax_syops.classify(ops, xj)
            assert all(v.dtype == torch.float32 and v.ndim == 0 for v in ours.values())
            assert host(ours) == host(theirs)
        sj = both(spikes)
        ours, theirs = syops.neuron_entry(xt, sj[1]), jax_syops.neuron_entry(xj, sj[0])
        assert all(v.dtype == torch.float32 and v.ndim == 0 for v in ours.values())
        assert host(ours) == host(theirs)


@pytest.mark.parametrize("backend", ["auto", "bnlif", "bnlif_torch"])
def test_vqvae_forward_equals_jax(tiny, backend):
    vq_vars, _, images, _, _, _ = tiny
    model = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend=JAX_BACKEND[backend])
    want = _jax_profile(model, vq_vars, images, train=False)
    vq = _vqvae(vq_vars, VQVAEConfig(**VQ_KW), backend)
    out, per_layer, total = syops.profile_apply(vq, torch.from_numpy(images), train=False)
    assert out["recon"].shape == (2, 28, 28, 1)
    assert_profiles_equal(per_layer, total, *want)
    assert len(per_layer) == 19 and 0.0 < total["acs"] and 0.0 < total["macs"]
    # every LIF layer fires, and not all the time
    rates = [e["rate"] for k, e in per_layer.items() if "LIF" in k or "lif" in k
             or "/counters/" in k or k == "vq_layer/counters"]
    assert len(rates) == 6 and all(0.0 < r < 1.0 for r in rates), rates
    assert syops.count_params(vq) == jax_syops.count_params(vq_vars["params"])


def test_vqvae_decode_indices_equals_jax(tiny):
    vq_vars, _, _, codes, _, _ = tiny
    model = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan")
    want = _jax_profile(model, vq_vars, codes, method="decode_indices")
    vq = _vqvae(vq_vars, VQVAEConfig(**VQ_KW))
    images, per_layer, total = syops.profile_apply(vq, torch.from_numpy(codes),
                                                   method="decode_indices")
    assert images.shape == (3, 28, 28, 1)
    assert_profiles_equal(per_layer, total, *want)
    assert len(per_layer) == 10


@pytest.mark.parametrize("backend", ["auto", "bnlif", "bnlifconv"])
def test_denoiser_equals_jax(tiny, backend):
    _, den_vars, _, _, tokens, t = tiny
    model = JaxDenoiser(JaxDiffusionConfig(**DEN_KW), backend=JAX_BACKEND[backend])
    want = _jax_profile(model, den_vars, tokens, t, train=False)
    den = _denoiser(den_vars, DiffusionConfig(**DEN_KW), backend)
    logits, per_layer, total = syops.profile_apply(den, torch.from_numpy(tokens),
                                                   torch.from_numpy(t))
    assert logits.shape == (3, 7, 7, DEN_KW["num_embeddings"])
    assert_profiles_equal(per_layer, total, *want)
    n = len(DEN_KW["denoiser_channels"])
    assert len(per_layer) == 3 * n + 1
    assert all(0.0 < per_layer[k]["rate"] < 1.0 for k in per_layer
               if "LIF" in k or k.startswith("counters/"))


@pytest.fixture(scope="module")
def e60():
    """(VQ-VAE variables, denoiser variables) of the committed e60 run."""
    vq = load_variables(CKPT, "model")
    den = load_variables(os.path.join(CKPT, "diff_result"), "diff_model")
    return ({"params": vq[0], "batch_stats": vq[1]}, {"params": den[0], "batch_stats": den[1]})


def test_e60_vqvae_equals_jax(e60):
    vq_vars, _ = e60
    images = (np.random.RandomState(6).uniform(0, 1, (2, 28, 28, 1)) - 0.5).astype(np.float32)
    want = _jax_profile(JaxSNNVQVAE(JaxVQVAEConfig(), backend="scan"), vq_vars, images,
                        train=False)
    vq = _vqvae(vq_vars, VQVAEConfig())
    _, per_layer, total = syops.profile_apply(vq, torch.from_numpy(images), train=False)
    assert_profiles_equal(per_layer, total, *want)
    assert syops.count_params(vq) == jax_syops.count_params(vq_vars["params"]) == 50658


def test_e60_denoiser_equals_jax(e60):
    _, den_vars = e60
    cfg = DiffusionConfig()
    rs = np.random.RandomState(7)
    tokens = rs.randint(0, cfg.num_embeddings + 1, (2, 7, 7)).astype(np.int32)
    t = np.asarray([10, 40], np.int32)
    want = _jax_profile(JaxDenoiser(JaxDiffusionConfig(), backend="scan"), den_vars,
                        tokens, t, train=False)
    den = _denoiser(den_vars, cfg)
    _, per_layer, total = syops.profile_apply(den, torch.from_numpy(tokens),
                                              torch.from_numpy(t))
    assert_profiles_equal(per_layer, total, *want)
    assert syops.count_params(den) == jax_syops.count_params(den_vars["params"])


def test_format_report_equals_jax(tiny):
    vq_vars, _, images, _, _, _ = tiny
    per_layer, total = _jax_profile(JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan"),
                                    vq_vars, images, train=False)
    n = jax_syops.count_params(vq_vars["params"])
    assert syops.format_report(per_layer, total, n) == \
        jax_syops.format_report(per_layer, total, n)
    assert syops.totals(per_layer) == jax_syops.totals(per_layer)
    assert syops.totals({}) == jax_syops.totals({})


def test_profile_dataset_equals_jax(tiny):
    vq_vars, _, images, _, _, _ = tiny
    batches = [images, images[::-1] * 0.5]
    model = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan")
    want = jax_syops.profile_dataset(model, vq_vars, [jnp.asarray(b) for b in batches],
                                     train=False)
    vq = _vqvae(vq_vars, VQVAEConfig(**VQ_KW))
    got = syops.profile_dataset(vq, [torch.from_numpy(np.ascontiguousarray(b))
                                     for b in batches], train=False)
    assert_profiles_equal(*got, *want)
    assert syops.profile_dataset(vq, [], train=False) == \
        jax_syops.profile_dataset(model, vq_vars, [], train=False)


def test_probe_energy_equals_jax_generation_energy(tiny):
    """JAX's ``generation_energy`` against the port's helper fed the codes
    and probes that JAX's draws with its key."""
    vq_vars, den_vars, _, _, _, _ = tiny
    jcfg = JaxDiffusionConfig(**DEN_KW)
    den_j = JaxDenoiser(jcfg, backend="scan")
    vq_j = JaxSNNVQVAE(JaxVQVAEConfig(**VQ_KW), backend="scan")
    key, n, probe_steps = jax.random.PRNGKey(8), 4, (8, 4, 1)
    want = jax_syops.generation_energy(den_j, den_vars, vq_j, vq_vars, jcfg, key,
                                       n_samples=n, probe_steps=probe_steps)

    def denoise(x_t, t):
        return den_j.apply(den_vars, x_t, t, train=False)

    codes = jax.jit(lambda k: jax_diffusion.sample(k, denoise, jcfg, n_samples=n,
                                                   temperature=0.8))(key)
    probes = []
    for t in probe_steps:
        t_vec = jnp.full((n,), t, jnp.int32)
        x_t, _, _ = jax_diffusion.q_sample(jax.random.fold_in(key, t), codes, t_vec,
                                           jcfg.mask_id, jcfg.num_timesteps)
        probes.append((torch.from_numpy(np.array(x_t)), torch.from_numpy(np.array(t_vec))))
    den = _denoiser(den_vars, DiffusionConfig(**DEN_KW))
    den.train()
    got = syops.probe_energy(den, _vqvae(vq_vars, VQVAEConfig(**VQ_KW)),
                             DiffusionConfig(**DEN_KW),
                             torch.from_numpy(np.array(codes)), probes)
    assert den.training  # its mode is restored
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=ENERGY_RTOL, atol=0, err_msg=k)
    assert got["energy_uJ_per_img"] > 0 and 0 < got["denoiser_spike_rate"] < 1


def test_generation_energy_runs_on_the_cpu(tiny):
    vq_vars, den_vars, _, _, _, _ = tiny
    cfg = DiffusionConfig(**DEN_KW)
    assert syops.default_probe_steps(cfg) == (8, 6, 4, 2, 1)
    gen = torch.Generator().manual_seed(0)
    got = syops.generation_energy(_denoiser(den_vars, cfg),
                                  _vqvae(vq_vars, VQVAEConfig(**VQ_KW)), cfg, gen,
                                  n_samples=3, device="cpu")
    assert all(np.isfinite(v) and v > 0 for v in got.values())
    assert 0 < got["denoiser_spike_rate"] < 1


def _hooks(model):
    return {name: (len(m._forward_hooks), len(m._forward_pre_hooks))
            for name, m in model.named_modules()}


@pytest.mark.parametrize("backend", ["auto", "bnlif"])
def test_profile_apply_leaves_the_model_as_it_was(tiny, backend):
    vq_vars, _, images, _, _, _ = tiny
    vq = _vqvae(vq_vars, VQVAEConfig(**VQ_KW), backend)
    seen = []
    vq.encoder.convs[0].register_forward_hook(lambda *a: seen.append(1))
    hooks = _hooks(vq)
    x = torch.from_numpy(images)
    plain = vq(x, train=False)["recon"]
    # the VQ-VAE's forward sets every module back to the root's mode after
    # it; profile_apply restores each module's own
    vq.train()
    vq.decoder.eval()
    modes = {name: m.training for name, m in vq.named_modules()}
    out, _, _ = syops.profile_apply(vq, x, train=False)
    torch.testing.assert_close(out["recon"], plain, rtol=0, atol=0)
    assert _hooks(vq) == hooks and len(seen) == 2  # the caller's hook stays and ran
    assert {name: m.training for name, m in vq.named_modules()} == modes
    assert all(m.profile is None for m in vq.modules() if isinstance(m, LIF))
    # a call that fails half way leaves no hook and no profile either

    def fail(*_):
        raise ValueError("stop")

    handle = vq.decoder.deconvs[2].register_forward_hook(fail)
    with pytest.raises(ValueError, match="stop"):
        syops.profile_apply(vq, x, train=False)
    handle.remove()
    assert _hooks(vq) == hooks
    assert all(m.profile is None for m in vq.modules() if isinstance(m, LIF))


def test_names_are_the_flax_paths(tiny):
    _, den_vars, _, _, _, _ = tiny
    den = _denoiser(den_vars, DiffusionConfig(**DEN_KW))
    n = syops.n_block_convs(den)
    assert syops.flax_path("readout", n) == "SeqConv_2"
    assert syops.flax_path("encoder.convs.0") == "encoder/SeqConv_0"
    assert syops.flax_path("vq_layer.poisson_lif") == "vq_layer/asg_lif"
    assert syops.flax_path("") == ""
    flax_params = set()
    jax.tree_util.tree_map_with_path(
        lambda p, _: flax_params.add("/".join(k.key for k in p)), den_vars["params"])
    assert {syops.flax_param_path(name, n) for name, _ in den.named_parameters()} == \
        flax_params


def _record_module():
    spec = importlib.util.spec_from_file_location("syops_jax_record", RECORD_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_committed_jax_record_regenerates():
    record = _record_module()
    with open(record.RECORD) as f:
        committed = json.load(f)
    assert json.loads(json.dumps(record.make_record(), sort_keys=True)) == committed
    assert committed["images"] == 32 and set(committed) >= {"auto", "bnlif"}
    assert len(committed["auto"]["per_layer"]) == len(committed["bnlif"]["per_layer"]) == 19
