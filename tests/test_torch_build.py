"""The CUDA build's cache key (``spiking_diffusion_tpu_torch/ops/_build.py``).

A library is named by a hash of its source, the ``csrc/`` headers the
source includes and the nvcc flags, so editing a shared header rebuilds
every source that includes it. Runs on the CPU: nothing is compiled.
"""

import shutil

import pytest

from spiking_diffusion_tpu_torch.ops import _build

SOURCES = ("lif_fwd", "lif_bwd", "bn_lif", "fused_denoiser", "spike_conv")


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    shutil.copytree(_build.CSRC_DIR, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path / "csrc")
    return tmp_path / "csrc"


def test_every_local_include_exists():
    for name in SOURCES:
        text = (_build.CSRC_DIR / f"{name}.cu").read_bytes()
        for header in _build._LOCAL_INCLUDE.findall(text):
            assert (_build.CSRC_DIR / header.decode()).is_file(), (name, header)


@pytest.mark.parametrize("edited,rebuilt", [
    ("lif_neuron.cuh", {"lif_fwd", "lif_bwd", "bn_lif"}),
    ("channel_sum.cuh", {"bn_lif", "spike_conv"}),
    ("bn_lif.cu", {"bn_lif"}),
    ("spike_conv.cu", {"spike_conv"}),
])
def test_library_name_follows_source_and_headers(csrc_copy, edited, rebuilt):
    before = {name: _build.library_path(name) for name in SOURCES}
    with open(csrc_copy / edited, "a") as f:
        f.write("\n// edited\n")
    after = {name: _build.library_path(name) for name in SOURCES}
    assert {name for name in SOURCES if after[name] != before[name]} == rebuilt
    assert all(p.parent == _build.BUILD_DIR for p in after.values())


def test_include_cycle_is_read_once(csrc_copy):
    (csrc_copy / "a.cuh").write_text('#include "b.cuh"\n')
    (csrc_copy / "b.cuh").write_text('#include "a.cuh"\n')
    (csrc_copy / "cyc.cu").write_text('  #include "a.cuh"\n#include <cuda_runtime.h>\n')
    text = _build._source_bytes(csrc_copy / "cyc.cu", set())
    assert text.count(b'#include "a.cuh"') == 2 and text.count(b'#include "b.cuh"') == 1
