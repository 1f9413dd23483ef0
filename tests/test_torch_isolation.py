"""The port imports no JAX and nothing of the JAX package.

Checked in a fresh interpreter: this test process may already hold jax
(``tests/conftest.py`` configures it, and other test files import it).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import downloader_tpu_torch
names = ["downloader_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(downloader_tpu_torch.__path__,
                                          "downloader_tpu_torch.")
    if m.name != "downloader_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
import chip_smoke
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "triton", "downloader_tpu")
hits = sorted(m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in banned))
print(len(names), "IMPORTED")
print("BANNED", hits)
"""


def test_port_and_chip_smoke_import_no_jax_or_reference():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    # every module of the package was walked (all but __main__)
    n_files = sum(f.endswith(".py") for _, _, files in
                  os.walk(os.path.join(REPO, "downloader_tpu_torch"))
                  for f in files)
    assert int(lines[0].split()[0]) == n_files - 1, lines
    assert lines[1] == "BANNED []", lines[1]


_ENTRY_PROBE = r"""
import sys
import downloader_tpu_torch.scripts.head_spike
import downloader_tpu_torch.compute.infer
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "triton", "downloader_tpu",
          "scripts")
hits = sorted(m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in banned))
print("BANNED", hits)
"""


def test_head_spike_and_infer_import_no_jax_reference_or_scripts():
    """The spike's counterpart and the RGB ``infer`` path stand alone:
    neither pulls in JAX, the JAX package or its ``scripts`` spike."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _ENTRY_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines()[-1] == "BANNED []", proc.stdout


_TRAIN_PROBE = r"""
import atexit, os, shutil, sys, tempfile
import numpy as np
import downloader_tpu_torch.compute.train
import downloader_tpu_torch.compute.trainer
import downloader_tpu_torch.compute.checkpoint
from downloader_tpu_torch.cli import main
from downloader_tpu_torch.compute.video import Y4MHeader, Y4MWriter
work = tempfile.mkdtemp()
atexit.register(shutil.rmtree, work)
rng = np.random.default_rng(0)
with open(os.path.join(work, "clip.y4m"), "wb") as fh:
    writer = Y4MWriter(fh, Y4MHeader(width=32, height=24, colorspace="420jpeg"))
    for _ in range(2):
        writer.write_frame(rng.integers(0, 256, (24, 32), np.uint8),
                           rng.integers(0, 256, (12, 16), np.uint8),
                           rng.integers(0, 256, (12, 16), np.uint8))
ckpt = os.path.join(work, "ckpt")
assert main(["train", "--data", work, "--steps", "2", "--batch", "2",
             "--crop", "16", "--features", "8", "--depth", "2",
             "--checkpoint-dir", ckpt, "--device", "cpu"]) == 0
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "triton",
          "downloader_tpu")
hits = sorted(m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in banned))
print("BANNED", hits)
"""


def test_train_command_imports_no_jax_or_reference():
    """The training plane (``compute.train``, ``compute.trainer``,
    ``compute.checkpoint``) and the ``train`` command, run end to end at a
    tiny size on the CPU, load no jax, flax, optax, orbax or JAX-package
    module."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _TRAIN_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert "trained to step 2 (loss" in proc.stdout, lines
    assert lines[-1] == "BANNED []", proc.stdout
