"""Package-level guarantees of the PyTorch port: it never imports JAX (nor
the JAX package), runs on the card unless asked for the CPU (and never falls
back to the CPU on its own), and its chip smoke refuses to run without a CUDA
card or outside a checkout."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from orbslam3_cpp_fork_tpu_torch.device import get_device

REPO = Path(__file__).resolve().parent.parent


def _run(code, cwd=REPO):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import orbslam3_cpp_fork_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'orbslam3_cpp_fork_tpu.')) or k == 'orbslam3_cpp_fork_tpu')\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = _run(code)
    assert out.returncode == 0, out.stderr


def test_chip_smoke_imports_no_jax():
    out = _run("import sys, chip_smoke\nassert 'jax' not in sys.modules and 'orbslam3_cpp_fork_tpu' not in sys.modules")
    assert out.returncode == 0, out.stderr


def test_chip_smoke_fails_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card refusal cannot be observed")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok": true' not in out.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and '"ok": true' not in out.stdout


def test_get_device_is_explicit():
    assert get_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False and torch.backends.cudnn.allow_tf32 is False
    if torch.cuda.is_available():
        assert get_device("cuda").index is not None
    else:
        with pytest.raises(RuntimeError):
            get_device("cuda")
    with pytest.raises(ValueError):
        get_device("meta")


def test_default_device_is_the_card():
    """With no argument the entry points mean the card: here, without one,
    they raise instead of running on the CPU."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    if torch.cuda.is_available():
        assert get_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        get_device()
    scene = synthetic.make_ring_scene(seed=7, n_points=50, size_range=(9, 15), width=80, height=60)
    Rs, ts = synthetic.circle_trajectory(n_frames=4, radius=2.5, total_angle=0.1)
    with pytest.raises(RuntimeError):
        synthetic.seed_local_map(scene, Rs, ts, capacity=16, kf_every=2)
