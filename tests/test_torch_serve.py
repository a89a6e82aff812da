"""The port's server and user scripts (``examples/*_torch.py``) on the CPU.

* ``serve_torch.Generator`` over a tiny seeded two-stage checkpoint saved
  as ``.pt``, fed JAX's noise, gives the JAX server's pipeline
  (``diffusion.sample`` then ``decode_indices``) its codes exactly and
  its images within 1e-5.
* Batch i of a seeded Generator is the i-th draw of ``generate.generate``
  from a generator seeded alike, with speculation on and off, through a
  change of temperature.
* An HTTP round trip on 127.0.0.1: a PNG grid of the ``_tile`` shape
  holding the served images, ``/healthz``, ``/stats``, a 400 and a 404;
  ``bench`` has the JAX server's keys.
* ``generate_torch.py``, ``deploy_netx_torch.py`` and
  ``lynxi_infer_torch.py`` run with ``--device cpu`` at tiny sizes.
"""

import functools
import importlib.util
import json
import os
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib
from http.server import ThreadingHTTPServer

import h5py
import jax
import numpy as np
import pytest
import torch

from spiking_diffusion_tpu.config import DiffusionConfig as JaxDiffusionConfig
from spiking_diffusion_tpu.config import VQVAEConfig as JaxVQVAEConfig
from spiking_diffusion_tpu.models import diffusion as jax_diffusion
from spiking_diffusion_tpu.models.denoiser import SpikingDenoiser as JaxDenoiser
from spiking_diffusion_tpu.models.vqvae import SNNVQVAE as JaxSNNVQVAE
from spiking_diffusion_tpu_torch import generate
from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.models import deploy, weights
from spiking_diffusion_tpu_torch.train.checkpoint import save_checkpoint
from spiking_diffusion_tpu_torch.train.state import create_train_state
from spiking_diffusion_tpu_torch.utils.grids import _tile, _to_uint8
from test_torch_generation import _amplify_bn, _jax_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL = 1e-5
TINY_CHANNELS = (4, 8, 8, 8, 4)
STEPS, CODEBOOK, BATCH = 4, 16, 4
BENCH_KEYS = {"batch", "requests", "speculate", "p50_s", "p90_s", "min_s", "max_s",
              "images_per_sec"}


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _narrow(monkeypatch, module):
    """The script's denoiser at tiny widths."""
    monkeypatch.setattr(module, "DiffusionConfig",
                        functools.partial(DiffusionConfig, denoiser_channels=TINY_CHANNELS))


def _configs():
    vcfg = VQVAEConfig(num_steps=STEPS, num_embeddings=CODEBOOK)
    dcfg = DiffusionConfig(num_embeddings=CODEBOOK, mask_id=CODEBOOK, num_steps=STEPS,
                           denoiser_channels=TINY_CHANNELS)
    return vcfg, dcfg


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A seeded two-stage checkpoint in the port's layout, and its flax
    variables."""
    root = tmp_path_factory.mktemp("ckpt")
    vcfg, dcfg = _configs()
    gen, rng = torch.Generator().manual_seed(5), np.random.RandomState(6)
    dparams, dstats = weights.init_denoiser_variables(dcfg, gen)
    vparams, vstats = weights.init_vqvae_variables(vcfg, gen)
    _amplify_bn(dstats, rng)
    _amplify_bn(vstats, rng)
    vq = weights.load_vqvae(vparams, vstats, vcfg, device="cpu")
    den = weights.load_denoiser(dparams, dstats, dcfg, device="cpu")
    save_checkpoint(create_train_state(vq), str(root), "model")
    save_checkpoint(create_train_state(den), str(root / "diff_result"), "diff_model")
    return str(root), {"params": vparams, "batch_stats": vstats}, \
        {"params": dparams, "batch_stats": dstats}


@pytest.fixture
def serve(monkeypatch):
    module = _example("serve_torch")
    _narrow(monkeypatch, module)
    return module


def test_generator_matches_jax_pipeline(serve, checkpoint):
    root, vvars, dvars = checkpoint
    gen = serve.Generator(root, BATCH, STEPS, CODEBOOK, device="cpu")
    jdcfg = JaxDiffusionConfig(num_embeddings=CODEBOOK, mask_id=CODEBOOK, num_steps=STEPS,
                               denoiser_channels=TINY_CHANNELS)
    den = JaxDenoiser(jdcfg, backend="scan")
    vq = JaxSNNVQVAE(JaxVQVAEConfig(num_steps=STEPS, num_embeddings=CODEBOOK), backend="scan")
    vvars = {"params": {**vvars["params"], "vq_layer": {**vvars["params"]["vq_layer"],
                                                        "alpha": np.float32(0.5)}},
             "batch_stats": vvars["batch_stats"]}

    @jax.jit
    def jax_generate(key):  # the JAX server's generate
        codes = jax_diffusion.sample(
            key, lambda x, t: den.apply(dvars, x, t, train=False), jdcfg, n_samples=BATCH,
            temperature=0.65)
        return codes, vq.apply(vvars, codes, method="decode_indices")

    key = jax.random.PRNGKey(7)
    codes_jax, images_jax = (np.asarray(a) for a in jax_generate(key))
    noise = _jax_noise(key, BATCH, 7, CODEBOOK, jdcfg.num_timesteps)
    codes, images = (a.numpy() for a in gen.draw(0.65, noise=noise))
    assert len(np.unique(codes)) > 1 and images.shape == (BATCH, 28, 28, 1)
    np.testing.assert_array_equal(codes, codes_jax)
    np.testing.assert_allclose(images, images_jax, atol=IMAGE_ATOL, rtol=0)


def test_speculation_changes_no_image(serve, checkpoint):
    root, _, _ = checkpoint
    temps = (0.65, 0.65, 0.9, 0.9, 0.65)  # a speculated batch drawn again twice
    served = {}
    for speculate in (True, False):
        gen = serve.Generator(root, BATCH, STEPS, CODEBOOK, device="cpu")
        gen.speculate = speculate
        served[speculate] = [gen.sample(BATCH, t) for t in temps]
    ref = torch.Generator().manual_seed(serve.SEED)
    for i, t in enumerate(temps):
        _, want = generate.generate(gen.denoiser, gen.vqvae, gen.d_cfg, BATCH, temperature=t,
                                    generator=ref, device="cpu")
        np.testing.assert_array_equal(served[True][i], want.numpy())
        np.testing.assert_array_equal(served[False][i], want.numpy())
    assert not np.array_equal(served[True][0], served[True][1])


def _decode_png(data: bytes) -> np.ndarray:
    """The pixels of a PNG of one IDAT with filter byte 0 on every row
    (what ``utils.grids.png_bytes`` writes)."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        chunks[kind] = data[pos + 8:pos + 8 + length]
        pos += 12 + length
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert depth == 8 and color == 0
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    assert not raw[:, 0].any()
    return raw[:, 1:]


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_http_round_trip_and_bench(serve, checkpoint):
    root, _, _ = checkpoint
    gen = serve.Generator(root, BATCH, STEPS, CODEBOOK, device="cpu")
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(gen))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        status, kind, body = _get(port, "/generate?n=3&temperature=0.8")
        assert (status, kind) == (200, "image/png")
        ref = torch.Generator().manual_seed(serve.SEED)
        _, want = generate.generate(gen.denoiser, gen.vqvae, gen.d_cfg, BATCH,
                                    temperature=0.8, generator=ref, device="cpu")
        grid = _tile(_to_uint8(want.numpy()[:3]), rows=1, cols=8)
        np.testing.assert_array_equal(_decode_png(body), grid)
        status, kind, body = _get(port, "/healthz")
        assert (status, kind) == (200, "application/json")
        assert json.loads(body) == {"status": "ok", "batch": BATCH}
        status, _, body = _get(port, "/stats")
        stats = json.loads(body)
        assert status == 200 and stats["batch"] == BATCH and stats["last_latency_s"] > 0
        for bad in ("/generate?temperature=0", "/generate?temperature=11", "/generate?n=x"):
            assert _get(port, bad)[0] == 400
        assert _get(port, "/nope")[0] == 404
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()
    out = gen.bench(requests=2)
    assert set(out) == BENCH_KEYS
    assert out["batch"] == BATCH and out["requests"] == 2 and out["speculate"] is True
    assert 0 < out["min_s"] <= out["p50_s"] <= out["max_s"] and out["images_per_sec"] > 0


def _main(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
    module.main()


def test_generate_script(monkeypatch, checkpoint, tmp_path, capsys):
    module = _example("generate_torch")
    _narrow(monkeypatch, module)
    out = tmp_path / "samples.png"
    _main(module, ["--checkpoint", checkpoint[0], "--n", "10", "--num_steps", str(STEPS),
                   "--codebook_size", str(CODEBOOK), "--out", str(out), "--device", "cpu"],
          monkeypatch)
    assert "wrote 10 samples" in capsys.readouterr().out
    pixels = _decode_png(out.read_bytes())
    assert pixels.shape == _tile(np.zeros((10, 28, 28), np.uint8), rows=2, cols=8).shape


def test_deploy_netx_script(monkeypatch, checkpoint, tmp_path):
    module = _example("deploy_netx_torch")
    _narrow(monkeypatch, module)
    _main(module, ["--checkpoint", checkpoint[0], "--out", str(tmp_path),
                   "--num_steps", str(STEPS), "--codebook_size", str(CODEBOOK),
                   "--device", "cpu"], monkeypatch)
    for name in ("denoiser.net", "encoder.net"):
        with h5py.File(tmp_path / name, "r") as f:
            assert bytes(f["layer/0/type"][()]) == b"input"
    variables, manifest = deploy.import_netlist(str(tmp_path / "svae"))
    assert manifest["meta"] == {"model": "snn-vq-vae", "T": STEPS}
    vvars = checkpoint[1]
    np.testing.assert_array_equal(variables["params"]["vq_layer"]["embeddings"],
                                  vvars["params"]["vq_layer"]["embeddings"])


def test_lynxi_script(tmp_path):
    module = _example("lynxi_infer_torch")
    res = module.run(epochs=1, n_train=128, n_test=32, T=2, out=str(tmp_path / "vgg"),
                     device="cpu")
    assert res["steps"] == 2 and res["agreement"] == 1.0
    assert res["max_abs_logit_diff"] <= IMAGE_ATOL
    assert os.path.exists(res["json"]) and os.path.exists(res["npz"])
