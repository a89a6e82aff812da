"""The port's PNG grids against the JAX package's, read back with PIL.

``save_image_grid``, ``save_recon_grid`` and the mode-coverage grids
(``per_class_grids``, ``paper_montage``) write files whose pixels, size
and mode equal those of the JAX package's PIL-written ones, for 1- and
3-channel images; the port's own PNG writer needs no PIL: a subprocess
with PIL blocked imports every module of the port and writes a grid.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from spiking_diffusion_tpu.metrics import mode_coverage as jax_mode
from spiking_diffusion_tpu.utils import grids as jax_grids
from spiking_diffusion_tpu_torch.metrics import mode_coverage
from spiking_diffusion_tpu_torch.utils import grids

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_PIL = """
import importlib, pkgutil, sys
sys.modules["PIL"] = None
import numpy as np
import spiking_diffusion_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from spiking_diffusion_tpu_torch.utils import save_image_grid
x = np.linspace(-0.6, 0.6, 32 * 28 * 28).reshape(32, 28, 28, 1)
print(save_image_grid(x, sys.argv[1]))
"""


def _images(n, channels, seed):
    rng = np.random.RandomState(seed)
    return rng.uniform(-0.7, 0.7, (n, 28, 28, channels)).astype(np.float32)


def _pixels(path):
    with Image.open(path) as im:
        return im.mode, im.size, np.asarray(im)


def _same_file_pixels(a, b):
    ma, sa, pa = _pixels(a)
    mb, sb, pb = _pixels(b)
    assert (ma, sa) == (mb, sb)
    np.testing.assert_array_equal(pa, pb)
    return ma


@pytest.mark.parametrize("channels,mode", [(1, "L"), (3, "RGB")])
@pytest.mark.parametrize("n,rows,cols", [(32, 4, 8), (13, 2, 8), (7, 3, 5)])
def test_image_grid_pixels(tmp_path, channels, mode, n, rows, cols):
    x = _images(n, channels, n + channels)
    ours = grids.save_image_grid(x, str(tmp_path / "port" / "g.png"), rows=rows, cols=cols)
    theirs = jax_grids.save_image_grid(x, str(tmp_path / "jax" / "g.png"), rows=rows, cols=cols)
    assert _same_file_pixels(ours, theirs) == mode


def test_image_grid_uint8(tmp_path):
    x = (np.random.RandomState(0).rand(32, 28, 28, 1) * 255).astype(np.uint8)
    ours = grids.save_image_grid(x, str(tmp_path / "a.png"), already_uint8=True)
    theirs = jax_grids.save_image_grid(x, str(tmp_path / "b.png"), already_uint8=True)
    _same_file_pixels(ours, theirs)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("n", [32, 12])
def test_recon_grid_pixels(tmp_path, channels, n):
    ori, rec = _images(n, channels, 1), _images(n, channels, 2)
    ours = grids.save_recon_grid(ori, rec, str(tmp_path / "a.png"))
    theirs = jax_grids.save_recon_grid(ori, rec, str(tmp_path / "b.png"))
    _same_file_pixels(ours, theirs)


def test_mode_coverage_grids(tmp_path):
    images = _images(60, 1, 5) + 0.5
    probs = np.random.RandomState(6).dirichlet(np.ones(10), size=60).astype(np.float32)
    probs[:, 9] = 0.0  # one class never predicted: no grid for it

    def fn(x):
        return np.zeros((len(x), 84), np.float32), probs[:len(x)]

    ours = mode_coverage.per_class_grids(fn, images, 10, str(tmp_path / "port"))
    theirs = jax_mode.per_class_grids(fn, images, 10, str(tmp_path / "jax"))
    assert sorted(ours) == sorted(theirs) and 9 not in ours
    for c in ours:
        assert os.path.basename(ours[c]) == os.path.basename(theirs[c]) == f"class_{c}.png"
        _same_file_pixels(ours[c], theirs[c])
    a = mode_coverage.paper_montage(fn, images, 10, str(tmp_path / "port" / "p.png"), per_class=2)
    b = jax_mode.paper_montage(fn, images, 10, str(tmp_path / "jax" / "p.png"), per_class=2)
    _same_file_pixels(a, b)


def test_png_structure(tmp_path):
    path = grids.write_png(str(tmp_path / "x.png"), np.arange(12, dtype=np.uint8).reshape(3, 4))
    data = open(path, "rb").read()
    assert data[:8] == grids.PNG_SIGNATURE and data[12:16] == b"IHDR"
    assert data[-12:] == bytes.fromhex("0000000049454e44ae426082")  # IEND and its CRC
    with pytest.raises(ValueError):
        grids.write_png(str(tmp_path / "y.png"), np.zeros((2, 2, 2), np.uint8))


def test_port_writes_grids_without_pil(tmp_path):
    out = tmp_path / "grid.png"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    run = subprocess.run([sys.executable, "-c", NO_PIL, str(out)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    mode, size, pixels = _pixels(out)
    assert mode == "L" and size == (8 * 30 - 2, 4 * 30 - 2)
    assert pixels.min() == 0 and pixels.max() == 255
