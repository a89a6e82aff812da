"""The port's timing harness (``profiling/timing.py``) against the JAX
package's ``profiling/timing.py``, on the CPU.

* ``benchmark`` returns JAX's keys, times with the host clock when the
  output lies on the CPU, and runs the function ``warmup + iters`` times.
* ``trace`` writes a Chrome trace that names the operators it ran.
"""

import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from spiking_diffusion_tpu.profiling import benchmark as jax_benchmark
from spiking_diffusion_tpu_torch.profiling import benchmark, timing, trace


@pytest.fixture(autouse=True)
def one_thread():
    torch.set_num_threads(1)


def test_benchmark_keys_equal_jax():
    x = torch.ones(128)
    calls = []

    def fn(v):
        calls.append(1)
        return {"y": v * 2 + 1}

    stats = benchmark(fn, x, iters=5, warmup=2)
    want = jax_benchmark(jax.jit(lambda v: v * 2 + 1), jnp.ones((128,)), iters=5, warmup=1)
    assert set(stats) == set(want)
    assert len(calls) == 7 and stats["iters"] == 5.0
    assert 0 < stats["min_ms"] <= stats["mean_ms"] and stats["calls_per_sec"] > 0


def test_device_of_nested_outputs():
    cpu = torch.device("cpu")
    assert timing._device_of(None) == cpu
    assert timing._device_of({"a": [1.0, (torch.ones(1),)]}) == cpu
    assert timing._device_of(torch.ones(1, device="meta")).type == "meta"
    assert timing._device_of([0, {"b": torch.ones(1, device="meta")}]).type == "meta"


def test_trace_writes_a_chrome_trace(tmp_path):
    a = torch.ones(16, 16)
    with trace(str(tmp_path / "t")) as log_dir:
        torch.mm(a, a).sum()
    assert log_dir == str(tmp_path / "t")
    with open(os.path.join(log_dir, timing.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mm" in names and "aten::sum" in names
