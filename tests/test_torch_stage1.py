"""One stage-1 training step of the port against the JAX package's.

A tiny spiking VQ-VAE (T=4, 12x12x1 images, encoder 8-16, D=8, K=16,
decoder 16-8, batch 4) is initialised by JAX ``SNNVQVAE.init(...,
train=True)`` and carried into the port by ``models/weights.py``; the
images come from the port's ``synthetic_dataset``. The JAX step is the
package's own ``make_train_step_vqvae(data_variance, donate=False)``.
Branches: layerwise (JAX 'scan' and 'pallas' in interpret mode against
the port's 'auto', K1's plain versions here) and fused (both 'bnlif', K3).
After one step:

* the encoder's spikes equal JAX's;
* ``vq_loss``, ``recon_loss`` and ``real_recon_loss`` within 1e-5;
* the gradients within rtol 2e-3, atol 2e-4, the JAX package's own
  tolerance between its branches (tests/test_denoiser_bnlif.py);
* the new BN running statistics within rtol 1e-5, atol 1e-6 (fp32 sums
  of up to T*N*H*W values in another order);
* the parameters after AdamW within 1e-6 of optax's. The conv biases
  ahead of a training-mode BN are the exception, as in
  tests/test_torch_stage2.py: BN subtracts the batch mean, so their
  gradient is zero in exact arithmetic and both sides hold rounding noise
  that AdamW scales towards +-lr; the test checks that the noise is small
  on both sides and that neither moved further than AdamW can move a
  parameter. So are the few other elements whose JAX gradient is not 0
  but below 1e-6, where the sum has cancelled to its rounding (at most
  1 % of the elements). The port's AdamW fed JAX's gradients is held within 1e-6 of
  optax on every parameter, those biases included.

The eval forward (running statistics away from identity) gives ``recon``
within 1e-5 and identical indices and re-spike trains. One bf16 step per
branch (``SNNVQVAE(dtype=bfloat16)``) gives the encoder spikes of JAX's
bf16 forward and a finite loss within 5 % of JAX's bf16 loss (the JAX
package's bf16 bound, tests/test_bf16.py): the bf16 readout sums and
deconvs run in another order in XLA on the CPU and in PyTorch. JAX is
compiled without XLA's excess precision there: with it, XLA on the CPU
drops the rounding of BN's bf16 output ahead of the LIF, and the
layerwise loss moves by ~6 % at this size.

Also: the usage loss ('snn-vq-vae-uni'), first-index tie-breaking in
``get_code_indices``, ``psp`` and the restructured PSP loss,
``extract_code_indices`` with a remainder batch, two ``train_vqvae``
epochs (lower loss, JAX's epoch order, one callback per epoch) and a
checkpoint round trip.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.data import batch_iterator as jax_batch_iterator
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu.ops import bn_lif as jax_bn_lif
from spiking_diffusion_tpu.ops import pallas_lif
from spiking_diffusion_tpu.snn.encoding import direct_encode as jax_direct_encode
from spiking_diffusion_tpu.snn.temporal import psp as jax_psp
from spiking_diffusion_tpu.train import stage1 as jax_stage1
from spiking_diffusion_tpu.train import state as jax_state
from spiking_diffusion_tpu_torch.config import VQVAEConfig
from spiking_diffusion_tpu_torch.data import data_variance, synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.models.layers import SeqConv, SeqConvTranspose
from spiking_diffusion_tpu_torch.snn.temporal import psp
from spiking_diffusion_tpu_torch.train import checkpoint, stage1
from spiking_diffusion_tpu_torch.train.state import create_train_state

KW = dict(num_steps=4, image_size=12, latent_size=3, enc_channels=(8, 16),
          embedding_dim=8, num_embeddings=16, dec_channels=(16, 8))
JCFG, CFG = JaxVQVAEConfig(**KW), VQVAEConfig(**KW)
BATCH = 4
LR = 1e-3
BRANCHES = {  # JAX backend -> the port's
    "layerwise_scan": ("scan", "auto"),
    "layerwise_pallas": ("pallas", "auto"),
    "bnlif": ("bnlif", "bnlif"),
}
BF16_LOSS_RTOL = 0.05  # tests/test_bf16.py: bf16 loss within 5 % of fp32
LOSS_ATOL = 1e-5
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)
STATS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_ATOL = 1e-6
IMAGE_ATOL = 1e-5
# the BN-cancelled biases' gradients, rounding noise around 0: up to ~1e-5
# where the decoder's 4,096 per-channel terms come straight from the loss
NOISE_GRAD = 2e-5
# a non-zero gradient element below this in JAX is at the level of the fp32
# rounding of its sum (a few in the encoder's BN biases), which AdamW's
# first step amplifies towards +-lr: such elements are held to AdamW's bound
TINY_GRAD = 1e-6
# conv biases whose gradient BN cancels: every conv and deconv ahead of a BN
BN_CANCELLED = ("encoder.convs.0.bias", "encoder.convs.1.bias", "encoder.convs.2.bias",
                "vq_layer.poisson_conv.bias", "decoder.deconvs.0.bias",
                "decoder.deconvs.1.bias")
LOSSES = ("vq_loss", "recon_loss", "real_recon_loss")


@pytest.fixture(autouse=True)
def setup():
    torch.set_num_threads(1)
    old = pallas_lif._INTERPRET, jax_bn_lif._INTERPRET
    pallas_lif._INTERPRET = jax_bn_lif._INTERPRET = True
    yield
    pallas_lif._INTERPRET, jax_bn_lif._INTERPRET = old


def _variables(jcfg, images):
    """JAX's init, with each BN's scale and bias moved off identity so that
    the LIF layers fire often at T = 4."""
    init = JaxSNNVQVAE(jcfg, backend="scan").init
    variables = jax.jit(lambda k, x: init(k, x, train=True))(
        jax.random.PRNGKey(0), jnp.asarray(images))
    variables = jax.tree_util.tree_map(np.array, jax.device_get(variables))
    rng = np.random.RandomState(2)

    def widen(tree):
        for key, node in tree.items():
            if key == "BatchNorm_0":
                node["scale"] = rng.uniform(1.5, 2.5, node["scale"].shape).astype(np.float32)
                node["bias"] = rng.uniform(-0.2, 0.4, node["bias"].shape).astype(np.float32)
            elif isinstance(node, dict):
                widen(node)

    widen(variables["params"])
    return {"params": variables["params"], "batch_stats": variables["batch_stats"]}


@pytest.fixture(scope="module")
def problem():
    """(images in [-0.5, 0.5], data variance, JAX variables as numpy)."""
    ds = synthetic_dataset("MNIST", n_train=16, n_test=4, image_size=CFG.image_size)
    images = ds.train_images[:BATCH] - 0.5
    return images, data_variance(ds.train_images), _variables(JCFG, images)


def _jax_step(jcfg, backend, images, var, variables, step=True):
    """(outputs, encoder spikes, grads, new params, new batch stats, the
    JAX state before the step), all numpy; without ``step`` the last three
    are None."""
    model = JaxSNNVQVAE(jcfg, backend=backend)
    stats = variables["batch_stats"]
    x = jnp.asarray(images)

    def loss_fn(p):
        out = model.apply({"params": p, "batch_stats": stats}, x, train=True,
                          data_variance=var, mutable=["batch_stats"])[0]
        return out["vq_loss"] + out["recon_loss"], out

    def encode(m, img):
        return m.encoder(jax_direct_encode(img, jcfg.num_steps), train=True,
                         first_replicated=True)

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    z = jax.jit(lambda v: model.apply(v, x, method=encode, mutable=["batch_stats"])[0])(
        variables)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    if not step:
        return to_np(out), np.asarray(z), to_np(grads), None, None, None
    state = jax_state.create_train_state(model, variables)
    new_state, _ = jax_stage1.make_train_step_vqvae(var, donate=False)(state, x)
    return (to_np(out), np.asarray(z), to_np(grads), to_np(new_state.params),
            to_np(new_state.batch_stats), state)


def _port_state(variables, backend, cfg=CFG, dtype=None):
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], cfg,
                            device="cpu", lif_backend=backend, train=True, dtype=dtype)
    return create_train_state(vq)


def _encoder_spikes(model):
    """A list that a hook fills with the encoder's output, (T, N, h, w, D)."""
    seen = []

    def hook(_module, _args, out):
        z = out.detach().float()
        z = z.reshape((CFG.num_steps, -1) + tuple(z.shape[1:]))
        seen.append(z.permute(0, 1, 3, 4, 2).numpy())

    model.encoder.register_forward_hook(hook)
    return seen


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_one_step_matches_jax(problem, branch):
    images, var, variables = problem
    jax_backend, port_backend = BRANCHES[branch]
    out_j, z_j, grads_j, params_j, stats_j, jstate = _jax_step(
        JCFG, jax_backend, images, var, variables)

    state = _port_state(variables, port_backend)
    seen = _encoder_spikes(state.model)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    metrics = stage1.make_train_step_vqvae(var)(state, torch.from_numpy(images))
    assert state.step == 1
    assert 0.05 < z_j.mean() < 0.95
    np.testing.assert_array_equal(seen[0], z_j)
    for k in LOSSES:
        assert abs(float(metrics[k]) - float(out_j[k])) <= LOSS_ATOL, k
    assert abs(float(metrics["loss"]) - float(out_j["vq_loss"] + out_j["recon_loss"])) \
        <= LOSS_ATOL

    grads = weights.vqvae_state_dict(grads_j, variables["batch_stats"])
    new = weights.vqvae_state_dict(params_j, stats_j)
    after = state.model.state_dict()
    tiny = total = 0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], err_msg=name, **GRAD_TOL)
        moved = [after[name] - before[name], torch.tensor(new[name]) - before[name]]
        bound = LR * (1.0 + 1e-3 * before[name].abs()) + 1e-7
        if name in BN_CANCELLED:
            assert np.abs(grads[name]).max() < NOISE_GRAD and p.grad.abs().max() < NOISE_GRAD
            noise = torch.ones(p.shape, dtype=torch.bool)
        else:
            g = np.asarray(np.abs(grads[name]))
            noise = torch.from_numpy(np.asarray((g < TINY_GRAD) & (g > 0)))
            tiny += int(noise.sum())
        total += p.numel()
        for m in moved:
            assert (m.abs() <= bound)[noise].all(), name
        diff = np.abs(after[name].numpy() - new[name])[~noise.numpy()]
        assert diff.size == 0 or diff.max() <= PARAM_ATOL, (name, diff.max())
    assert tiny <= 0.01 * total, (tiny, total)
    for name in after:
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(after[name].numpy(), new[name], err_msg=name, **STATS_TOL)

    # the port's AdamW fed JAX's gradients against optax, every parameter
    optax_params = weights.vqvae_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.apply_gradients(
            jax.tree_util.tree_map(jnp.asarray, grads_j)).params),
        variables["batch_stats"])
    state = _port_state(variables, port_backend)
    for name, p in state.model.named_parameters():
        p.grad = torch.from_numpy(np.array(grads[name]))
    state.optimizer.step()
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), optax_params[name], rtol=0,
                                   atol=PARAM_ATOL, err_msg=name)


def _eval_variables(variables):
    """Running statistics away from identity, so every LIF layer fires in
    eval mode."""
    stats = copy.deepcopy(variables["batch_stats"])
    rng = np.random.RandomState(1)

    def amplify(tree):
        for key, node in tree.items():
            if key == "BatchNorm_0":
                node["mean"] = rng.uniform(-0.2, 0.2, node["mean"].shape).astype(np.float32)
                node["var"] = rng.uniform(0.01, 0.05, node["var"].shape).astype(np.float32)
            else:
                amplify(node)

    amplify(stats)
    return {"params": variables["params"], "batch_stats": stats}


@pytest.mark.parametrize("branch", ["layerwise_pallas", "bnlif"])
def test_eval_forward_matches_jax(problem, branch):
    images, _, variables = problem
    variables = _eval_variables(variables)
    jax_backend, port_backend = BRANCHES[branch]
    model = JaxSNNVQVAE(JCFG, backend=jax_backend)
    out_j = jax.jit(lambda v, x: model.apply(v, x, train=False))(variables, jnp.asarray(images))
    codes_j = jax.jit(lambda v, x: model.apply(v, x, method="encode_indices"))(
        variables, jnp.asarray(images))
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], CFG,
                            device="cpu", lif_backend=port_backend)
    out = vq(torch.from_numpy(images))
    assert not vq.training and not out["recon"].requires_grad
    spikes = np.asarray(out_j["spikes"])
    assert 0.05 < spikes.mean() < 0.95
    np.testing.assert_array_equal(out["spikes"].numpy(), spikes)
    np.testing.assert_array_equal(out["indices"].numpy(), np.asarray(out_j["indices"]))
    assert len(np.unique(out["indices"].numpy())) > 1
    np.testing.assert_allclose(out["recon"].numpy(), np.asarray(out_j["recon"]),
                               atol=IMAGE_ATOL, rtol=0)
    codes = vq.encode_indices(torch.from_numpy(images))
    assert codes.dtype == torch.int32 and codes.shape == (BATCH, 3, 3)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(codes_j))
    recon, indices = stage1.eval_step_vqvae(vq, torch.from_numpy(images))
    assert torch.equal(recon, out["recon"]) and torch.equal(indices, out["indices"])


def _dtypes(model, run):
    """(every dtype a conv or deconv took in or gave out, run())."""
    seen = set()

    def hook(module, args, out):
        seen.update((args[0].dtype, out.dtype))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (SeqConv, SeqConvTranspose))
               and m is not model.vq_layer.poisson_conv]
    try:
        return seen, run()
    finally:
        for h in handles:
            h.remove()


def _jax_bf16_forward(backend, images, var, variables):
    """(training-mode outputs, encoder spikes) of JAX's bf16 VQ-VAE, as
    written: compiled without XLA's excess precision, which on the CPU
    would drop the rounding of BN's bf16 output ahead of the LIF (a
    convert to bf16 and back), so that the program's bf16 is what is held."""
    model = JaxSNNVQVAE(JCFG, backend=backend, dtype=jnp.bfloat16)
    apply = functools.partial(model.apply, mutable=["batch_stats"])

    def run(v, x):
        out = apply(v, x, train=True, data_variance=var)[0]
        z = apply(v, x, method=lambda m, img: m.encoder(
            jax_direct_encode(img, JCFG.num_steps), train=True, first_replicated=True))[0]
        return out, z

    x = jnp.asarray(images)
    compiled = jax.jit(run).lower(variables, x).compile(
        {"xla_allow_excess_precision": False})
    return jax.tree_util.tree_map(np.asarray, compiled(variables, x))


@pytest.mark.parametrize("branch", ["layerwise_scan", "bnlif"])
def test_one_bf16_step_matches_jax(problem, branch):
    """The bf16 VQ-VAE's step against JAX's bf16 forward: the encoder's
    spikes equal, the loss finite and within 5 % of JAX's, bf16 convs and
    spikes in the encoder and decoder (the quantizer stays fp32), fp32
    parameters and gradients."""
    images, var, variables = problem
    jax_backend, port_backend = BRANCHES[branch]
    out_j, z_j = _jax_bf16_forward(jax_backend, images, var, variables)
    loss_j = float(out_j["vq_loss"] + out_j["recon_loss"])
    state = _port_state(variables, port_backend, dtype=torch.bfloat16)
    seen = _encoder_spikes(state.model)
    dtypes, metrics = _dtypes(state.model, lambda: stage1.make_train_step_vqvae(var)(
        state, torch.from_numpy(images)))
    loss = float(metrics["loss"])
    assert dtypes == {torch.bfloat16}, dtypes
    np.testing.assert_array_equal(seen[0], z_j.astype(np.float32))
    assert np.isfinite(loss) and np.isfinite(loss_j)
    assert abs(loss - loss_j) <= BF16_LOSS_RTOL * abs(loss_j), (loss, loss_j)
    print(f"{branch} bf16: loss {loss:.6f}, JAX {loss_j:.6f}")
    for name, p in state.model.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert bool(torch.isfinite(p).all()), name


def test_usage_loss_matches_jax(problem):
    """'snn-vq-vae-uni': the usage loss in the step, against JAX."""
    images, var, _ = problem
    kw = dict(KW, usage_loss_weight=0.1)
    jcfg, cfg = JaxVQVAEConfig(**kw), VQVAEConfig(**kw)
    variables = _variables(jcfg, images)
    out_j, _, grads_j, _, _, _ = _jax_step(jcfg, "scan", images, var, variables, step=False)
    state = _port_state(variables, "auto", cfg)
    metrics = stage1.make_train_step_vqvae(var)(state, torch.from_numpy(images))
    assert abs(float(metrics["vq_loss"]) - float(out_j["vq_loss"])) <= LOSS_ATOL
    grads = weights.vqvae_state_dict(grads_j, variables["batch_stats"])
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], err_msg=name, **GRAD_TOL)
    plain = _port_state(variables, "auto")  # the same weights without the term
    loss_plain = stage1.make_train_step_vqvae(var)(plain, torch.from_numpy(images))["vq_loss"]
    assert float(metrics["vq_loss"]) > float(loss_plain)


def test_code_indices_first_index_wins(problem):
    """Rows equidistant from several codes take the first of them, as
    JAX's argmin does; the nearest code otherwise."""
    _, _, variables = problem
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], CFG,
                            device="cpu").vq_layer
    k, d = CFG.num_embeddings, CFG.embedding_dim
    emb = np.zeros((k, d), np.float32)
    emb[:, 0] = np.arange(k, dtype=np.float32)  # codes on a line, one apart
    emb[9] = emb[4]  # a duplicate code: 4 wins
    with torch.no_grad():
        vq.embeddings.copy_(torch.from_numpy(emb))
    flat = np.zeros((5, d), np.float32)
    flat[:, 0] = [2.5, 4.0, 7.5, 0.25, 14.5]  # midpoints tie, 4.0 hits 4 and 9
    want = [2, 4, 7, 0, 14]
    got = vq.get_code_indices(torch.from_numpy(flat)).numpy()
    model = JaxSNNVQVAE(JCFG, backend="scan")
    params = copy.deepcopy(variables["params"])
    params["vq_layer"]["embeddings"] = emb
    got_j = model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(flat), method=lambda m, x: m.vq_layer.get_code_indices(x))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(got_j), want)


def test_psp_matches_jax():
    """Bitwise at the configuration's tau_s = 2 (an exact halving); within
    an fp32 rounding at tau_s = 3, where XLA on the CPU rewrites the
    division."""
    x = np.random.RandomState(3).rand(6, 2, 3, 5).astype(np.float32)
    want = np.asarray(jax_psp(jnp.asarray(x), 2.0))
    np.testing.assert_array_equal(psp(torch.from_numpy(x), 2.0).numpy(), want)
    want = np.asarray(jax_psp(jnp.asarray(x), 3.0))
    np.testing.assert_allclose(psp(torch.from_numpy(x), 3.0).numpy(), want, rtol=1e-6,
                               atol=0)


def test_psp_loss_restructuring_matches_naive_form():
    """The quantizer's single-pass PSP loss equals the two-train form
    mean((psp(q) - sg psp(z))^2) + beta * mean((sg psp(q) - psp(z))^2) in
    value and in the gradients toward the spikes and the encoder output."""
    beta, tau = CFG.commitment_cost, CFG.psp_tau_s
    rng = np.random.RandomState(7)
    shape = (CFG.num_steps, 2, 3, 3, CFG.embedding_dim)
    spikes0 = torch.from_numpy((rng.rand(*shape) < 0.4).astype(np.float32))
    z0 = torch.from_numpy((rng.rand(*shape) < 0.3).astype(np.float32))

    def naive(spikes, z):
        pq, pz = psp(spikes, tau), psp(z, tau)
        return torch.mean((pq - pz.detach()) ** 2) + beta * torch.mean((pq.detach() - pz) ** 2)

    def restructured(spikes, z):
        d = spikes - (beta * z + (1.0 - beta) * z.detach())
        v = torch.mean(psp(d, tau) ** 2)
        return v + (beta * v).detach()

    results = []
    for fn in (naive, restructured):
        spikes, z = spikes0.clone().requires_grad_(), z0.clone().requires_grad_()
        value = fn(spikes, z)
        value.backward()
        results.append((value.item(), spikes.grad, z.grad))
    (v1, gs1, gz1), (v2, gs2, gz2) = results
    np.testing.assert_allclose(v1, v2, rtol=1e-6)
    torch.testing.assert_close(gs1, gs2, rtol=0, atol=1e-7)
    torch.testing.assert_close(gz1, gz2, rtol=0, atol=1e-7)


def test_extract_code_indices_matches_jax(problem):
    _, _, variables = problem
    variables = _eval_variables(variables)
    raw = synthetic_dataset("MNIST", n_train=10, n_test=2, image_size=CFG.image_size, seed=4).train_images
    model = JaxSNNVQVAE(JCFG, backend="scan")
    jstate = jax_state.create_train_state(model, variables)
    want = jax_stage1.extract_code_indices(jstate, raw, batch_size=4)  # 4 + 4 + 2
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], CFG, device="cpu")
    got = stage1.extract_code_indices(vq, raw, batch_size=4, device="cpu")
    assert got.dtype == np.int32 and got.shape == (10, 3, 3)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 1


def test_train_vqvae_follows_jax_order_and_lowers_the_loss(problem, monkeypatch):
    _, var, variables = problem
    raw = synthetic_dataset("MNIST", n_train=10, n_test=2, image_size=CFG.image_size, seed=5).train_images
    seen = []
    real_make_step = stage1.make_train_step_vqvae

    def spy(data_var):
        step = real_make_step(data_var)

        def recorded(state, images):
            seen.append(images.numpy().copy())
            return step(state, images)

        return recorded

    monkeypatch.setattr(stage1, "make_train_step_vqvae", spy)
    vq = weights.load_vqvae(variables["params"], variables["batch_stats"], CFG,
                            device="cpu", train=True)
    probe = torch.from_numpy(raw[:BATCH] - 0.5)

    def fixed_loss(model):
        with torch.no_grad():
            out = copy.deepcopy(model)(probe, train=True, data_variance=var)
        return float(out["vq_loss"] + out["recon_loss"])

    before = fixed_loss(vq)
    logged, epochs_seen = [], []
    state = stage1.train_vqvae(vq, raw, var, epochs=2, batch_size=BATCH, learning_rate=1e-2,
                               seed=3, log_every=1, log_fn=logged.append,
                               epoch_callback=lambda e, s: epochs_seen.append((e, s.step)),
                               device="cpu")
    assert state.step == 4 and epochs_seen == [(0, 2), (1, 4)]
    want = [b - 0.5 for e in range(2)
            for b in jax_batch_iterator(raw, BATCH, seed=3, epoch=e)]
    assert len(seen) == len(want) == 4
    for got, batch in zip(seen, want):
        np.testing.assert_array_equal(got, batch.astype(np.float32))
    losses = [float(line.split("loss ")[1].split()[0]) for line in logged if "loss " in line]
    assert len(losses) == 4 and np.isfinite(losses).all()
    after = fixed_loss(state.model)
    assert np.isfinite(after) and after < before, (before, after)


def test_checkpoint_round_trip(problem, tmp_path):
    images, var, variables = problem
    state = _port_state(variables, "auto")
    step = stage1.make_train_step_vqvae(var)
    step(state, torch.from_numpy(images))
    path = checkpoint.save_checkpoint(state, str(tmp_path), "vqvae")
    assert checkpoint.checkpoint_exists(str(tmp_path), "vqvae") and path.endswith("vqvae.pt")
    saved = {k: v.clone() for k, v in state.model.state_dict().items()}
    saved_opt = copy.deepcopy(state.optimizer.state_dict())
    step(state, torch.from_numpy(images))  # move everything on
    fresh = _port_state(variables, "auto")
    for restored in (checkpoint.restore_checkpoint(state, str(tmp_path), "vqvae"),
                     checkpoint.restore_checkpoint(fresh, str(tmp_path), "vqvae")):
        assert restored.step == 1
        for k, v in restored.model.state_dict().items():
            assert torch.equal(v, saved[k]), k
        opt = restored.optimizer.state_dict()
        assert opt["param_groups"] == saved_opt["param_groups"]
        for i, s in saved_opt["state"].items():
            for k, v in s.items():
                assert torch.equal(opt["state"][i][k], v), (i, k)
    assert float(saved["vq_layer.alpha"]) != 0.5  # alpha trains and is saved
