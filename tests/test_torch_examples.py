"""The torch variants of the examples (``examples/*_torch.py``) against the
JAX examples.

Each example's step function against the JAX example's (rebuilt here
where the JAX example keeps it inside ``main``) on the same numpy inputs,
the weights carried across (``weights.load_zoo_model``,
``scoped_state_dict``, ``mlp_state_dict``, ``ann2snn_params``, or the JAX
layout itself): losses and outputs within 1e-5, gradients within 1e-5 of
each tensor's largest, spikes and data exact. The CartPole environment
bitwise JAX's on the same seeds and actions. Then every ``_torch`` script's
``main`` on the CPU at tiny flags.
"""

import importlib.util
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spiking_diffusion_tpu.data import events as jax_events
from spiking_diffusion_tpu.models import ann2snn as jax_ann2snn
from spiking_diffusion_tpu.models import zoo as jax_zoo
from spiking_diffusion_tpu.snn import learning as jax_learning
from spiking_diffusion_tpu.snn.fptt import fptt_online_training as jax_fptt
from spiking_diffusion_tpu.snn.tempotron import gaussian_tuning_encode as jax_encode
from spiking_diffusion_tpu.snn.tempotron import tempotron_classify as jax_classify
from spiking_diffusion_tpu_torch.data import synthetic_dataset
from spiking_diffusion_tpu_torch.models import weights
from spiking_diffusion_tpu_torch.snn import learning

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=atol)


def _grads_close(named_grads, want, zero=()):
    """Port gradients (name -> tensor) against JAX's carried into the port's
    names: within GRAD_RTOL of each tensor's largest; the tensors named in
    ``zero``, whose gradient is 0 in exact arithmetic or vanishes beside the
    others', within GRAD_RTOL of the largest gradient of all."""
    assert sorted(named_grads) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    for name, g in named_grads.items():
        w = np.asarray(want[name], np.float64)
        scale = top if name in zero else max(float(np.abs(w).max()), 1e-12)
        _close(g.detach().numpy(), w.reshape(g.shape), atol=GRAD_RTOL * scale)


def _param_grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


# --- dvs_classify ------------------------------------------------------------


def test_dvs_events_and_frames_match_jax():
    jx, tx = _load("dvs_classify"), _load("dvs_classify_torch")
    events, labels, order = tx.make_events(6, 0)
    rng = np.random.RandomState(0)
    frames_j, labels_j = [], []
    for cls in range(jx.CLASSES):
        for _ in range(6):
            ev = jx.make_event_sample(rng, cls)
            i = len(frames_j)
            for k in "txyp":
                assert events[i][k].dtype == ev[k].dtype
                np.testing.assert_array_equal(events[i][k], ev[k])
            frames_j.append(np.clip(jax_events.integrate_events_to_frames(
                ev, jx.H, jx.W, jx.T_FRAMES, "time", use_native=False), 0, 1))
            labels_j.append(cls)
    order_j = rng.permutation(len(frames_j))
    np.testing.assert_array_equal(order, order_j)
    x, y = tx.make_dataset(6, 0)  # the native integrator
    np.testing.assert_array_equal(x, np.stack(frames_j)[order_j].astype(np.float32))
    np.testing.assert_array_equal(y, np.asarray(labels_j, np.int32)[order_j])


def test_dvs_step_and_prediction_match_jax():
    tx = _load("dvs_classify_torch")
    x, y = tx.make_dataset(2, 0)
    jmodel = jax_zoo.SpikingVGG(cfg=tx.CFG, num_classes=tx.CLASSES, backend="scan")
    xj = jnp.asarray(x.transpose(1, 0, 2, 3, 4))
    variables = _np(jmodel.init(jax.random.PRNGKey(0), xj, train=True))
    params, stats = variables["params"], variables["batch_stats"]
    # a conv bias ahead of a training-mode BN changes nothing but the
    # conditioning: with JAX's random ones the BN's fp32 variance
    # E[x^2] - E[x]^2 over sparse binary frames loses digits to
    # cancellation, and either side's gradients move by ~3e-4 of their
    # largest with the order of the sums
    for name, node in params.items():
        if name.startswith("SeqConv"):
            node["Conv_0"]["bias"] = np.zeros_like(node["Conv_0"]["bias"])

    def loss_fn(p):
        logits, mut = jmodel.apply({"params": p, "batch_stats": stats}, xj, train=True,
                                   mutable=["batch_stats"])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), mut["batch_stats"]

    (loss_j, stats_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(params)
    kw = dict(cfg=tx.CFG, num_classes=tx.CLASSES, input_shape=x.shape[2:])
    model = weights.load_zoo_model("vgg", params, stats, device="cpu", train=True, **kw)
    loss = tx.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(loss_j))
    want = weights.zoo_state_dict(_np(grads_j), _np(stats_j))
    _grads_close(_param_grads(model), {n: want[n] for n, _ in model.named_parameters()},
                 zero=("convs.0.bias", "convs.1.bias"))
    for name, buf in model.named_buffers():  # BN running statistics after the step
        _close(buf.numpy(), want[name])
    # the prediction pass in eval mode, JAX's running statistics
    preds_j = jmodel.apply({"params": params, "batch_stats": _np(stats_j)}, xj,
                           train=False).argmax(-1)
    np.testing.assert_array_equal(tx.predict(model, torch.from_numpy(x)).numpy(),
                                  np.asarray(preds_j))


# --- speechcommands_kws --------------------------------------------------------


def test_speechcommands_features_and_net_match_jax(tmp_path):
    jx, tx = _load("speechcommands_kws"), _load("speechcommands_kws_torch")
    np.testing.assert_array_equal(tx.mel_filterbank(tx.N_FFT // 2 + 1),
                                  jx.mel_filterbank(jx.N_FFT // 2 + 1))
    root = tx.SpeechCommands.synthesize(str(tmp_path), labels=("yes", "no"), per_label=4)
    label_dict = {"yes": 0, "no": 1, "_silence_": 2}
    ds = tx.SpeechCommands(label_dict, root, "train")
    fb = tx.mel_filterbank(tx.N_FFT // 2 + 1)
    x, y = tx.featurize(ds, [0, 1, 3], fb)
    feats = np.stack([jx.features(ds[i][0], fb) for i in (0, 1, 3)])[..., None]
    std = feats.std(axis=(0, 1), keepdims=True)
    np.testing.assert_array_equal(x, feats / np.where(std == 0, 1, std))

    params_j = _np(jx.init_params(jax.random.PRNGKey(0), 3, tx.N_MELS, 3))
    params_j["w1"] = params_j["w1"] * np.float32(40.0)  # the first block fires at this size
    params_t = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params_j.items()}

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jx.net_apply(p, jnp.asarray(x)), jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params_j)
    loss, acc = tx.loss_and_accuracy(params_t, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(loss_j))
    # the first block's gradient crosses three LIF scans' surrogates: ~1e-8
    # of the readout's
    _grads_close({k: v.grad for k, v in params_t.items()}, _np(grads_j), zero=("w1",))


# --- ann2snn_cnn_mnist ---------------------------------------------------------


def test_ann2snn_loss_and_gradients_match_jax():
    jx, tx = _load("ann2snn_cnn_mnist"), _load("ann2snn_cnn_mnist_torch")
    ds = synthetic_dataset("MNIST", n_train=8, n_test=1, seed=2)
    x, y = ds.train_images, ds.train_labels.astype(np.int64)
    params_j = _np(jx.init_params(jax.random.PRNGKey(0)))
    params_t = tx.to_device(params_j, "cpu")

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jax_ann2snn.ann_forward(jx.SPECS, p, jnp.asarray(x)), jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params_j)
    loss = tx.loss_fn(params_t, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(loss_j))
    want = weights.ann2snn_params(tx.SPECS, _np(grads_j))
    for got, w in zip(params_t, want):
        if got is not None:
            _grads_close({k: v.grad for k, v in got.items()}, {k: v.numpy() for k, v in w.items()})
    # the port's initialiser: JAX's shapes and the truncated He-normal law
    init = tx.init_params(seed=1)
    for a, b in zip(init, params_j):
        assert (a is None) == (b is None)
        if a is not None:
            assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in b.items()}
    k = init[7]["kernel"]
    assert abs(k.std() / np.sqrt(2.0 / k.shape[0]) - 1.0) < 0.05
    assert np.abs(k).max() <= 2 * np.sqrt(2.0 / k.shape[0]) / tx._TRUNC_STD + 1e-6


# --- tempotron_mnist -----------------------------------------------------------


def test_tempotron_step_matches_jax():
    tx = _load("tempotron_mnist_torch")
    ds = synthetic_dataset("MNIST", n_train=6, n_test=1, seed=3)
    x, y = tx.pool14(ds.train_images), ds.train_labels.astype(np.int64)
    m, t_n, v_th, lr = 4, 16, 1.0, 1e-2
    w = np.random.RandomState(0).randn(10, 196 * m).astype(np.float32) * 0.05
    t_grid = jnp.arange(t_n, dtype=jnp.float32)

    def loss_fn(wj):
        t_spikes = jax_encode(jnp.asarray(x), m, float(t_n), 0.0, 1.0).reshape(x.shape[0], -1)
        v_peak, _ = jax_classify(wj, t_spikes, t_grid, v_th)
        fired = (v_peak >= v_th).astype(jnp.float32)
        wrong = jax.lax.stop_gradient((fired != jax.nn.one_hot(y, 10)).astype(jnp.float32))
        return jnp.sum(((v_peak - v_th) * wrong) ** 2) / y.shape[0]

    loss_j, g_j = jax.value_and_grad(loss_fn)(jnp.asarray(w))
    assert float(loss_j) > 0
    new_w, loss, _ = tx.train_step(torch.from_numpy(w), torch.from_numpy(x), torch.from_numpy(y),
                                   m, torch.arange(t_n, dtype=torch.float32), v_th, lr)
    _close(loss.item(), float(loss_j))
    g = (torch.from_numpy(w) - new_w) / lr
    _grads_close({"w": g}, {"w": np.asarray(g_j)})


# --- stdp_trace ----------------------------------------------------------------


def test_stdp_online_run_matches_jax():
    jx, tx = _load("stdp_trace"), _load("stdp_trace_torch")
    w_j, traj_j, in_j, out_j = jx.run_online_stdp(jax.random.PRNGKey(0), T=48)
    w, traj, out = tx.run_online_stdp(torch.from_numpy(np.array(in_j)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(out_j))
    _close(w.numpy(), w_j, atol=1e-6)
    _close(traj.numpy(), traj_j, atol=1e-6)
    s_pre, s_post = np.array(in_j), np.array(out_j)
    for r in (1.0, -1.0):
        reward = np.full((48,), r, np.float32)
        _close(learning.mstdp_scan(*map(torch.from_numpy, (s_pre, s_post, reward))).numpy(),
               jax_learning.mstdp_scan(s_pre, s_post, reward), atol=1e-5)
        _close(learning.mstdpet_scan(*map(torch.from_numpy, (s_pre, s_post, reward))).numpy(),
               jax_learning.mstdpet_scan(s_pre, s_post, reward), atol=1e-5)


# --- fptt_online ---------------------------------------------------------------


def test_fptt_epoch_matches_jax():
    jx, tx = _load("fptt_online"), _load("fptt_online_torch")
    params, x_seq, target, state0 = tx.make_problem("cpu")
    as_j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    p_j, losses_j = jax_fptt(jx.cell_apply, {k: as_j(v) for k, v in params.items()},
                             as_j(state0), as_j(x_seq), as_j(target),
                             lambda a, b: jnp.mean((a - b) ** 2), lr=tx.LR, alpha=tx.ALPHA)
    p, losses = tx.epoch(params, x_seq, target, state0)
    _close(losses.numpy(), losses_j)
    for k in p:
        _close(p[k].numpy(), p_j[k])


# --- rsnn_sequential_fmnist, spiking_lstm_mnist / _text ------------------------


def _jax_rsnn(kind, hidden):
    """The JAX example's Net (``rsnn_sequential_fmnist.py``)."""
    import flax.linen as nn

    from spiking_diffusion_tpu.models.recurrent import (
        LinearRecurrentContainer,
        SynapseFilter,
        lif_cell,
    )
    from spiking_diffusion_tpu.snn.neuron import NeuronParams, if_scan

    p_if = NeuronParams(tau=1e9, decay_input=False)

    class Net(nn.Module):
        @nn.compact
        def __call__(self, rows):
            h = nn.Dense(hidden)(rows)
            if kind == "feedback":
                s = LinearRecurrentContainer(out_features=hidden)(h, lif_cell(p_if))
            else:
                s, _ = if_scan(h)
            if kind == "synapse":
                s = SynapseFilter(tau=2.0, learnable=True)(s)
            s2, _ = if_scan(nn.Dense(10)(s))
            return jnp.mean(s2, axis=0)

    return Net()


def _jax_lstm(hidden, classes):
    """The JAX examples' spiking-LSTM Net (``spiking_lstm_*.py``)."""
    import flax.linen as nn

    from spiking_diffusion_tpu.snn.rnn import SpikingRNN

    class Net(nn.Module):
        @nn.compact
        def __call__(self, rows):
            ys, _ = SpikingRNN(hidden=hidden, cell_type="lstm")(rows)
            return nn.Dense(classes)(ys[-1])

    return Net()


def _rows(n=4, seed=4):
    ds = synthetic_dataset("MNIST", n_train=n, n_test=1, seed=seed)
    return ds.train_images.reshape(-1, 28, 28), ds.train_labels.astype(np.int64)


def _scale_dense(params, factor):
    """Dense kernels scaled up so that every IF layer fires at this size."""
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * np.float32(factor) if path[-1].key == "kernel" else v, params)


@pytest.mark.parametrize("kind", ["plain", "synapse", "feedback"])
def test_rsnn_step_matches_jax(kind):
    tx = _load("rsnn_sequential_fmnist_torch")
    x, y = _rows()
    jnet = _jax_rsnn(kind, 12)
    xj = jnp.asarray(x.transpose(1, 0, 2))
    params = _scale_dense(_np(jnet.init(jax.random.PRNGKey(0), xj)["params"]), 3.0)

    def loss_fn(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            jnet.apply({"params": p}, xj) * 28.0, jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    model = tx.Net(kind, 12)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.scoped_state_dict(params, tx.SCOPES[kind]).items()})
    rates = model(torch.from_numpy(x).permute(1, 0, 2))
    _close(rates.detach().numpy(), jnet.apply({"params": params}, xj), atol=1e-6)
    assert 0.0 < float(rates.mean()) < 1.0
    loss = tx.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(loss_j))
    _grads_close(_param_grads(model), weights.scoped_state_dict(_np(grads_j), tx.SCOPES[kind]))


@pytest.mark.parametrize("example", ["spiking_lstm_mnist_torch", "spiking_lstm_text_torch"])
def test_spiking_lstm_step_matches_jax(example):
    tx = _load(example)
    if example == "spiking_lstm_mnist_torch":
        x, y = _rows()
        classes = 10
        model = tx.Net(28, 16, classes)
    else:
        jx = _load("spiking_lstm_text")
        cats, train, test = tx.make_samples(np.random.RandomState(0))
        rng = np.random.RandomState(0)  # the JAX example's draws
        cats_j = sorted(jx.SYNTH_LANGS)
        samples = [(jx.synth_name(rng, lang), i) for i, lang in enumerate(cats_j)
                   for _ in range(1500)]
        rng.shuffle(samples)
        assert (cats, test, train) == (cats_j, samples[:450], samples[450:])
        x = np.stack([tx.encode(n) for n, _ in train[:4]])
        np.testing.assert_array_equal(x, np.stack([jx.encode(n) for n, _ in train[:4]]))
        y = np.asarray([c for _, c in train[:4]], np.int64)
        classes = len(cats)
        model = tx.Net(tx.N_LETTERS, 16, classes)
    jnet = _jax_lstm(16, classes)
    xj = jnp.asarray(x.transpose(1, 0, 2))
    params = _scale_dense(_np(jnet.init(jax.random.PRNGKey(0), xj)["params"]), 2.0)

    def loss_fn(p):
        logits = jnet.apply({"params": p}, xj)
        if example == "spiking_lstm_mnist_torch":  # the reference's MSE on one-hot targets
            return jnp.mean((logits - jax.nn.one_hot(y, 10)) ** 2)
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    scopes = _load("spiking_lstm_mnist_torch").SCOPES  # both examples' Net
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           weights.scoped_state_dict(params, scopes).items()})
    loss, _ = tx.loss_fn(model, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(loss_j))
    _grads_close(_param_grads(model), weights.scoped_state_dict(_np(grads_j), scopes))


# --- the CartPole examples -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_cartpole_env_bitwise(seed):
    jx, tx = _load("rl_cartpole_dqn"), _load("rl_cartpole_dqn_torch")
    ej, et = jx.CartPole(seed), tx.CartPole(seed)
    actions = np.random.RandomState(seed).randint(0, 2, 300)
    np.testing.assert_array_equal(ej.reset(), et.reset())
    for a in actions:
        (sj, rj, dj), (st, rt, dt) = ej.step(int(a)), et.step(int(a))
        np.testing.assert_array_equal(sj, st)
        assert (rj, dj, ej.steps) == (rt, dt, et.steps)
        if dj:
            np.testing.assert_array_equal(ej.reset(), et.reset())


def _states(n=6, seed=5):
    return (np.random.RandomState(seed).randn(n, 4) * 0.1).astype(np.float32)


def test_dqn_q_values_and_loss_match_jax():
    jx, tx = _load("rl_cartpole_dqn"), _load("rl_cartpole_dqn_torch")
    params = _np(jx.init_params(jax.random.PRNGKey(0)))
    target = jax.tree.map(lambda v: v * np.float32(0.9), params)
    q_net, t_net = tx.QNet(torch.Generator()), tx.QNet(torch.Generator())
    q_net.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.mlp_state_dict(params, tx.LAYERS).items()})
    t_net.load_state_dict({k: torch.from_numpy(v) for k, v in
                           weights.mlp_state_dict(target, tx.LAYERS).items()})
    s, s2 = _states(), _states(seed=6)
    rng = np.random.RandomState(7)
    a = rng.randint(0, 2, 6)
    r = np.ones(6, np.float32)
    done = (rng.rand(6) > 0.7).astype(np.float32)
    q_j = jx.q_apply(params, jnp.asarray(s))
    _close(q_net(torch.from_numpy(s)).detach().numpy(), q_j, atol=1e-6)

    def loss_fn(p):
        q_sa = jnp.take_along_axis(jx.q_apply(p, jnp.asarray(s)), a[:, None], axis=1)[:, 0]
        y = r + 0.99 * jnp.max(jx.q_apply(target, jnp.asarray(s2)), axis=1) * (1.0 - done)
        return jnp.mean((q_sa - jax.lax.stop_gradient(y)) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    batch = tuple(map(torch.from_numpy, (s, a, r, s2, done)))
    loss = tx.dqn_loss(q_net, t_net, *batch, 0.99)
    loss.backward()
    _close(loss.item(), float(loss_j))
    _grads_close(_param_grads(q_net), weights.mlp_state_dict(_np(grads_j), tx.LAYERS))
    # nn.Linear's own law from the generator: the same draws give the same net
    a_net, b_net = tx.QNet(torch.Generator().manual_seed(1)), tx.QNet(torch.Generator().manual_seed(1))
    for (n, p), (_, q) in zip(a_net.named_parameters(), b_net.named_parameters()):
        assert torch.equal(p, q), n
    bound = 1.0 / np.sqrt(4)
    assert float(a_net.fc1.weight.abs().max()) <= bound and float(a_net.fc1.bias.abs().max()) <= bound


def _actor_critic(tx, dqn, params):
    model = tx.ActorCritic(hidden=params["actor"]["w1"].shape[1])
    sd = {}
    for head in ("actor", "critic"):
        sd.update({f"{head}.{k}": torch.from_numpy(v) for k, v in
                   weights.mlp_state_dict(params[head], dqn.LAYERS).items()})
    model.load_state_dict(sd)
    return model


def _ac_grads(dqn, grads):
    out = {}
    for head in ("actor", "critic"):
        out.update({f"{head}.{k}": v for k, v in
                    weights.mlp_state_dict(grads[head], dqn.LAYERS).items()})
    return out


def test_a2c_forward_and_loss_match_jax():
    jx, tx, dqn = _load("rl_cartpole_a2c"), _load("rl_cartpole_a2c_torch"), _load(
        "rl_cartpole_dqn_torch")
    params = _np(jx.init_params(jax.random.PRNGKey(0), hidden=16))
    model = _actor_critic(tx, dqn, params)
    s = _states(8).reshape(2, 4, 4)
    logits_j, value_j = jx.ac_apply(params, jnp.asarray(s[0]))
    logits, value = model(torch.from_numpy(s[0]))
    _close(logits.detach().numpy(), logits_j, atol=1e-6)
    _close(value.detach().numpy(), value_j, atol=1e-6)
    a = np.random.RandomState(8).randint(0, 2, (2, 4))
    ret = np.random.RandomState(9).randn(2, 4).astype(np.float32)

    def loss_fn(p):
        lg, v = jax.vmap(lambda st: jx.ac_apply(p, st))(jnp.asarray(s))
        logp = jax.nn.log_softmax(lg)
        act_logp = jnp.take_along_axis(logp, a[..., None], axis=-1)[..., 0]
        adv = ret - v
        ent = -(jax.nn.softmax(lg) * logp).sum(-1).mean()
        return (-(act_logp * jax.lax.stop_gradient(adv)).mean() + 0.5 * (adv ** 2).mean()
                - 0.001 * ent)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    loss, _ = tx.a2c_loss(model, *map(torch.from_numpy, (s, a, ret)), 0.5, 0.001)
    loss.backward()
    _close(loss.item(), float(loss_j))
    _grads_close(_param_grads(model), _ac_grads(dqn, _np(grads_j)))


def test_ppo_gae_and_loss_match_jax():
    jx, tx = _load("rl_cartpole_ppo"), _load("rl_cartpole_ppo_torch")
    ja2c, dqn = _load("rl_cartpole_a2c"), _load("rl_cartpole_dqn_torch")
    rng = np.random.RandomState(10)
    r, m = np.ones((6, 3)), (rng.rand(6, 3) > 0.2).astype(np.float64)
    v, nv = rng.randn(6, 3).astype(np.float32), rng.randn(3).astype(np.float32)
    for got, want in zip(tx.compute_gae(r, m, v, nv), jx.compute_gae(r, m, v, nv)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    params = _np(ja2c.init_params(jax.random.PRNGKey(1), hidden=16))
    model = _actor_critic(_load("rl_cartpole_a2c_torch"), dqn, params)
    s = _states(8)
    a = rng.randint(0, 2, 8)
    old = (np.log(np.full(8, 0.5)) + rng.randn(8) * 0.1).astype(np.float32)
    ret, adv = rng.randn(8).astype(np.float32), rng.randn(8).astype(np.float32)

    def loss_fn(p):
        lg, val = ja2c.ac_apply(p, jnp.asarray(s))
        logp_all = jax.nn.log_softmax(lg)
        logp = jnp.take_along_axis(logp_all, a[:, None], axis=-1)[:, 0]
        ratio = jnp.exp(logp - old)
        surr = jnp.minimum(ratio * adv, jnp.clip(ratio, 0.8, 1.2) * adv)
        ent = -(jax.nn.softmax(lg) * logp_all).sum(-1).mean()
        return -surr.mean() + 0.5 * ((ret - val) ** 2).mean() - 0.001 * ent

    loss_j, grads_j = jax.value_and_grad(loss_fn)(params)
    loss, _ = tx.ppo_loss(model, *map(torch.from_numpy, (s, a, old, ret, adv)), 0.2, 0.5, 0.001)
    loss.backward()
    _close(loss.item(), float(loss_j))
    _grads_close(_param_grads(model), _ac_grads(dqn, _np(grads_j)))


# --- every script's main on the CPU, at tiny flags ------------------------------

MAINS = {
    "dvs_classify_torch": (["--epochs", "2", "--n_per_class", "16"], "test accuracy"),
    "classify_mnist_torch": (["--epochs", "1", "--num_steps", "2", "--channels", "4"],
                             "test accuracy"),
    "speechcommands_kws_torch": (["--epochs", "1", "--channels", "2", "--batch_size", "2",
                                  "--steps_per_epoch", "1"], "test_acc"),
    "ann2snn_cnn_mnist_torch": (["--epochs", "1", "--steps", "4", "--calib_size", "32",
                                 "--eval_size", "32"], "SNN T=  4"),
    "tempotron_mnist_torch": (["--epochs", "1", "--train_size", "128", "--test_size", "64",
                               "-m", "4", "-T", "8", "--batch_size", "32"], "epoch 0"),
    "stdp_trace_torch": (["--T", "32"], "MSTDP total"),
    "fptt_online_torch": (["--epochs", "2"], "epoch 1"),
    "rsnn_sequential_fmnist_torch": (["--epochs", "1", "--n_train", "64", "--n_test", "32",
                                      "--hidden", "8"], "feedback"),
    "spiking_lstm_mnist_torch": (["--epochs", "1", "--n_train", "64", "--n_test", "32",
                                  "--hidden", "8"], "test accuracy"),
    "spiking_lstm_text_torch": (["--iters", "5", "--hidden", "8", "--batch_size", "8"],
                                "test accuracy"),
    "rl_cartpole_dqn_torch": (["--episodes", "6"], "mean return"),
    "rl_cartpole_a2c_torch": (["--updates", "4", "--eval_every", "2"], "final eval reward"),
    "rl_cartpole_ppo_torch": (["--rollouts", "2", "--n_steps", "8", "--ppo_epochs", "1",
                               "--minibatch", "16", "--hidden", "16", "--eval_every", "99"],
                              "final eval reward"),
}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_cpu(name, capsys, monkeypatch, tmp_path):
    argv, last = MAINS[name]
    module = _load(name)
    if hasattr(module, "load_dataset"):  # the synthetic sets at a tiny size
        orig = module.load_dataset
        monkeypatch.setattr(module, "load_dataset", lambda *a, **kw: orig(
            *a, **{**kw, "synthetic_size": (128, 64)}))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))  # trees the examples write
    out = module.main(argv + ["--device", "cpu"])
    assert last in capsys.readouterr().out
    assert isinstance(out, dict)
