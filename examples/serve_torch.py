"""Example: serve Spiking-Diffusion generation over HTTP, on the card.

The PyTorch port's counterpart of ``examples/serve.py``: a stdlib-only
server around a two-stage checkpoint of the port
(``<checkpoint>/model.pt``, ``<checkpoint>/diff_result/diff_model.pt``).
One sampler per process, built once: the fused denoiser K2 on the card
(``make_denoise_fn(fused="auto")``, ``--dtype fp32|bf16|int8``), then
the VQ-VAE decode (K1). Every request is served at the batch the
sampler was built for. GET /generate?n=16&temperature=0.65 returns a PNG
grid (8 columns); GET /healthz returns liveness, GET /stats the last
request's latency.

    python examples/serve_torch.py --checkpoint result_torch/MNIST/snn-vq-vae --dtype bf16
    python examples/serve_torch.py --checkpoint result_torch/MNIST/snn-vq-vae --bench 8

Runs on the card unless ``--device cpu`` is passed.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import dataclasses
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from spiking_diffusion_tpu_torch.config import DiffusionConfig, VQVAEConfig
from spiking_diffusion_tpu_torch.device import resolve_device
from spiking_diffusion_tpu_torch.models import diffusion
from spiking_diffusion_tpu_torch.ops.fused_denoiser import make_denoise_fn
from spiking_diffusion_tpu_torch.train.checkpoint import restore_two_stage
from spiking_diffusion_tpu_torch.utils.grids import _tile, _to_uint8, png_bytes

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
SEED = 1234  # the JAX server's PRNGKey(1234)


@dataclasses.dataclass
class Batch:
    """One drawn batch: its images on the device, its temperature and the
    generator's state before its draws (to draw it again)."""

    images: torch.Tensor
    temperature: float
    state: torch.Tensor


class Generator:
    """Thread-safe wrapper over one sampler.

    Batch i of a generator seeded ``seed`` is the i-th draw of
    ``generate.generate`` from a ``torch.Generator`` seeded alike, whether
    ``speculate`` is on or off: speculation changes timing, never images.
    With it on, each request queues the next batch (at its temperature)
    before it waits for its own images' device-to-host copy, so the card
    computes the next batch while the host finishes this request. A
    speculated batch whose temperature the next request does not ask for
    is drawn again, from the generator state it was drawn from.
    """

    def __init__(self, checkpoint: str, batch: int, num_steps: int, codebook: int,
                 dtype: str = "fp32", device="cuda", seed: int = SEED):
        self.device = resolve_device(device)
        vq_cfg = VQVAEConfig(num_steps=num_steps, num_embeddings=codebook)
        self.d_cfg = DiffusionConfig(num_embeddings=codebook, mask_id=codebook,
                                     num_steps=num_steps)
        self.vqvae, self.denoiser = restore_two_stage(checkpoint, vq_cfg, self.d_cfg,
                                                      self.device)
        self.batch = batch
        self._denoise = make_denoise_fn(self.denoiser, self.d_cfg, fused="auto",
                                        dtype=DTYPES[dtype])
        self._steps = len(diffusion.schedule(self.d_cfg)[0])
        self._lock = threading.Lock()
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._pending: Optional[Batch] = None
        self.speculate = True
        self.last_latency_s = 0.0
        # warm-up: one batch from a generator seeded alike, which leaves the
        # served draws where they start
        self.draw(0.65, torch.Generator(device=self.device).manual_seed(seed))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def draw(self, temperature: float, generator: Optional[torch.Generator] = None,
             noise=None):
        """((N, h, w) codes, (N, H, W, C) images) of one batch on the device,
        queued: the sampler on per-step noise drawn from ``generator``, or
        on the given ``noise`` ((u, g) per step), then the decode."""
        if noise is None:
            noise = diffusion.draw_noise(self.d_cfg, self.batch, self._steps, generator,
                                         self.device)
        codes = diffusion.sample(self._denoise, self.d_cfg, self.batch, noise,
                                 temperature=temperature, device=self.device)
        return codes, self.vqvae.decode_indices(codes)

    def _next(self, temperature: float, state: Optional[torch.Tensor] = None) -> Batch:
        """Queue the next draw, or with ``state`` the draw made from it."""
        generator = self._generator
        if state is None:
            state = generator.get_state()
        else:
            generator = torch.Generator(device=self.device)
            generator.set_state(state)
        return Batch(self.draw(temperature, generator)[1], temperature, state)

    def _to_host(self, images: torch.Tensor):
        """Queue the copy of ``images`` into pinned host memory; (the host
        tensor, an event recorded after the copy, or None on the CPU)."""
        if self.device.type != "cuda":
            return images, None
        host = torch.empty(images.shape, dtype=images.dtype, pin_memory=True)
        host.copy_(images, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        return host, copied

    def sample(self, n: int, temperature: float) -> np.ndarray:
        """The first ``n`` images of the next batch, (n, H, W, C) in
        [-1, 1]."""
        with self._lock:
            t0 = time.perf_counter()
            pending, self._pending = self._pending, None
            if pending is not None and pending.temperature == temperature:
                images = pending.images
            else:
                images = self._next(temperature, pending.state if pending else None).images
            host, copied = self._to_host(images)
            if self.speculate:  # queued behind this batch's copy
                self._pending = self._next(temperature)
            if copied is not None:
                copied.synchronize()
            out = host.numpy()
            self.last_latency_s = time.perf_counter() - t0
        return out[:n]

    def bench(self, requests: int = 8, temperature: float = 0.65) -> dict:
        """Measured serving latency at the sampler's batch: sequential
        requests, each timed to its images on the host. The first request
        primes the speculative pipeline and is left out."""
        self.sample(self.batch, temperature)
        lats = []
        for _ in range(requests):
            t0 = time.perf_counter()
            self.sample(self.batch, temperature)
            lats.append(time.perf_counter() - t0)
        lats.sort()
        return {
            "batch": self.batch,
            "requests": requests,
            "speculate": self.speculate,
            "p50_s": round(lats[len(lats) // 2], 4),
            "p90_s": round(lats[min(len(lats) - 1, int(0.9 * len(lats)))], 4),
            "min_s": round(lats[0], 4),
            "max_s": round(lats[-1], 4),
            "images_per_sec": round(self.batch / lats[len(lats) // 2], 2),
        }


def make_handler(gen: Generator):
    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/healthz":
                self._send("application/json",
                           json.dumps({"status": "ok", "batch": gen.batch}).encode())
                return
            if url.path == "/stats":
                self._send("application/json", json.dumps({
                    "batch": gen.batch,
                    "last_latency_s": round(gen.last_latency_s, 4),
                }).encode())
                return
            if url.path != "/generate":
                self.send_error(404)
                return
            q = parse_qs(url.query)
            try:
                n = max(1, min(int(q.get("n", ["16"])[0]), gen.batch))
                temp = float(q.get("temperature", ["0.65"])[0])
                if not (0.0 < temp <= 10.0):
                    raise ValueError("temperature out of range")
            except ValueError as e:
                self.send_error(400, f"bad parameter: {e}")
                return
            images = gen.sample(n, temp)
            grid = _tile(_to_uint8(images), rows=-(-n // 8), cols=8)
            self._send("image/png", png_bytes(grid))

        def _send(self, content_type: str, body: bytes):
            self.send_response(200)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            print("[serve]", fmt % args)

    return Handler


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--num_steps", type=int, default=16)
    p.add_argument("--codebook_size", type=int, default=128)
    p.add_argument("--dtype", default="fp32", choices=list(DTYPES),
                   help="the fused sampler's weights (K2 on the card)")
    p.add_argument("--bench", type=int, default=0,
                   help="measure serving latency over N sequential "
                        "requests at the sampler's batch, print JSON, exit")
    p.add_argument("--speculate", type=int, default=1,
                   help="queue the next batch while serving this one "
                        "(overlaps compute with the host copy)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    if resolve_device(args.device).type == "cuda":
        # full fp32 convs and matmuls, not TF32, as the CLI
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = Generator(args.checkpoint, args.batch, args.num_steps, args.codebook_size,
                    dtype=args.dtype, device=args.device)
    gen.speculate = bool(args.speculate)
    if args.bench:
        print(json.dumps(gen.bench(args.bench)))
        return
    server = ThreadingHTTPServer(("0.0.0.0", args.port), make_handler(gen))
    print(f"serving on :{args.port} (batch {args.batch})")
    server.serve_forever()


if __name__ == "__main__":
    main()
