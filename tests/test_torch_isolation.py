"""The port imports no JAX and nothing of the JAX package.

Checked in a fresh interpreter: this test process may already hold jax
(``tests/conftest.py`` configures it, and other test files import it).
"""

import os
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

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
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
          "triton", "downloader_tpu")
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
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "zstandard", "triton",
          "downloader_tpu", "scripts")
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
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
          "triton", "downloader_tpu")
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


_MESH_PROBE = r"""
import datetime, sys, tempfile
import numpy as np
import torch
import torch.distributed as dist
from downloader_tpu_torch.graft_entry import _dryrun_worker, dryrun_multichip, entry
from downloader_tpu_torch.compute.infer import make_infer_fn
from downloader_tpu_torch.compute.models.upscaler import Upscaler, UpscalerConfig
from downloader_tpu_torch.compute.overlap_probe import measure_overlap
from downloader_tpu_torch.compute.parallel import MeshPlan
from downloader_tpu_torch.compute.pipeline import FrameUpscaler
fn, args = entry(device="cpu")
with torch.inference_mode():
    fn(*args)
print(dryrun_multichip(2, device="cpu"))
# a worker's lazy imports, run in this process on a one-rank group
store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                      timeout=datetime.timedelta(seconds=60))
dist.init_process_group("gloo", store=store, rank=0, world_size=1)
with tempfile.TemporaryDirectory() as ckpt:
    print(_dryrun_worker(print, "cpu", 1, False, ckpt))
dist.destroy_process_group()
config = UpscalerConfig(features=8, depth=2)
frames = np.zeros((3, 4, 4, 3), np.uint8)
make_infer_fn(config, mesh=MeshPlan.over(["cpu"] * 2))(Upscaler(config).state_dict(), frames)
measure_overlap(FrameUpscaler(config, batch=2, devices=["cpu"] * 2), batches=1,
                frame_interval=0.001)
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard",
          "triton", "downloader_tpu")
hits = sorted(m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in banned))
print("BANNED", hits)
"""


def test_mesh_paths_import_no_jax_or_reference():
    """The multi-device path run for real at a tiny size on the CPU — the
    entry points (``dryrun_multichip`` in a 2-rank gloo group, and its
    worker in this process), ``infer`` and the engine over several
    devices, the overlap probe — loads no jax, flax, optax, orbax or
    JAX-package module (the spawned workers import only the port)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _MESH_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[0].startswith("dryrun_multichip ok: mesh={'data': 1, 'model': 2}")
    assert lines[-1] == "BANNED []", proc.stdout


_SERVICE_CONFIG = """\
instance:
  download_path: {root}/downloads
  upscale: {{enabled: true, features: 8, depth: 2, batch: 4, device: cpu}}
rabbitmq: {{backend: memory}}
minio: {{backend: fs, root: {root}/store}}
"""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode()


def test_service_entry_point_serves_and_stops(tmp_path):
    """``python -m downloader_tpu_torch`` with no arguments runs the
    staging service, the upscale stage on the CPU: it answers ``/health``
    (500 ``Not Running Jobs`` when idle, the reference's semantics) and
    ``/metrics``, stops cleanly on SIGTERM, and imports no JAX and nothing
    of the JAX package (``-X importtime`` lists every module it loaded)."""
    (tmp_path / "converter.yaml").write_text(
        _SERVICE_CONFIG.format(root=tmp_path))
    port = _free_port()
    env = dict(os.environ, CONFIG_PATH=str(tmp_path), PORT=str(port),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log_path = tmp_path / "service.log"
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m", "downloader_tpu_torch"],
            cwd=tmp_path, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 60
            health = None
            while health is None:
                assert proc.poll() is None, log_path.read_text()[-3000:]
                assert time.monotonic() < deadline, "the service never answered"
                try:
                    health = _get(f"http://127.0.0.1:{port}/health")
                except (urllib.error.URLError, ConnectionError):
                    time.sleep(0.1)
            assert health[0] == 500 and "Not Running Jobs" in health[1], health
            status, metrics = _get(f"http://127.0.0.1:{port}/metrics")
            assert status == 200 and "frames_upscaled_total" in metrics
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = log_path.read_text()
    assert "upscale stage enabled" in out and "shutdown complete" in out
    loaded = {line.rsplit("|", 1)[1].strip() for line in out.splitlines()
              if line.startswith("import time:") and "|" in line}
    assert "downloader_tpu_torch.stages.upscale" in loaded
    banned = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
              "zstandard", "downloader_tpu")
    assert sorted(m for m in loaded
                  if any(m == b or m.startswith(b + ".") for b in banned)) == []


_REGISTRY_PROBE = r"""
import sys
from downloader_tpu_torch.stages import base
for name in sorted(base._REGISTRY):
    print(name, base.get_stage_factory(name).__module__)
hits = sorted(m for m in sys.modules if m == "downloader_tpu"
              or m.startswith("downloader_tpu.") or m.split(".")[0] == "jax")
print("BANNED", hits)
"""


def test_stage_registry_resolves_to_the_port():
    """Every name of the port's stage registry resolves, in a fresh
    interpreter, to a ``downloader_tpu_torch.stages`` module."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", _REGISTRY_PROBE], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "BANNED []", lines
    resolved = dict(line.split() for line in lines[:-1])
    assert set(resolved) == {"download", "process", "upload", "upscale"}
    for name, module in resolved.items():
        assert module == f"downloader_tpu_torch.stages.{name}"


BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
          "zstandard", "downloader_tpu")
# the reference's test-side modules that import the JAX package
REFERENCE_TEST_MODULES = ("test_soak", "miniamqp", "minitracker")

_LAZY_PROBE = r"""
import ast, asyncio, json, os, sys, tempfile, types
fixture, banned = sys.argv[1], tuple(sys.argv[2].split(","))
from downloader_tpu_torch.incident.compiler import (compile_bundle,
                                                    scenario_profile)
with open(fixture, encoding="utf-8") as fh:
    scenario = compile_bundle(json.load(fh))
profile = scenario_profile(scenario)
print("PROFILE", type(profile).__module__, type(profile).__name__,
      profile.jobs)

# every world is built for real (broker, MiniS3, origins, rig); only the
# fleet's run is left out
from downloader_tpu_torch.soak.rig import SoakRig
runs = []
async def run(self, workload):
    runs.append(type(self).__module__ + " " + type(workload).__module__)
    return types.SimpleNamespace(ok=True)
SoakRig.run = run

from downloader_tpu_torch.incident.fuzz import _replay_variant, fuzz_scenarios
entry = fuzz_scenarios(scenario, seed=0, variants=1)[0]
with tempfile.TemporaryDirectory() as tmp:
    result = asyncio.run(_replay_variant(entry, tmp))
print("FUZZ", result["guards_ok"], runs[-1])

from downloader_tpu_torch.cli import main
rc = main(["incident", "replay", "--bundle", fixture, "--no-report"])
print("REPLAY", rc, runs[-1])
world = sys.modules["test_torch_soak"]
print("WORLD", world.SoakRig.__module__, world.MiniAmqpServer.__module__,
      world.S3ObjectStore.__module__, world.MiniS3.__module__,
      world.RangeOrigin.__module__)

# chip_smoke.py's phase 14, "operator": every import statement of its
# functions, run as the phase runs them
import chip_smoke
with open(chip_smoke.__file__, encoding="utf-8") as fh:
    tree = ast.parse(fh.read())
names = set(chip_smoke.OPERATOR_FUNCTIONS)
imports = [node for fn in tree.body
           if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
           and fn.name in names for node in ast.walk(fn)
           if isinstance(node, (ast.Import, ast.ImportFrom))]
chip_smoke._tests_on_path()
for node in imports:
    exec(compile(ast.Module(body=[node], type_ignores=[]), "chip_smoke.py",
                 "exec"), dict(chip_smoke.__dict__))
print("CHIP_SMOKE", len(imports), "imports of", sorted(names))
hits = sorted(m for m in sys.modules
              if any(m == b or m.startswith(b + ".") for b in banned))
print("BANNED", hits)
"""


def test_lazy_paths_import_no_jax_or_reference():
    """The paths that import lazily stay on the port, in a fresh
    interpreter: ``scenario_profile`` returns the port's ``SoakProfile``;
    the fuzzer's ``_replay_variant`` and the CLI's ``incident replay``
    build the port's soak world (``tests/test_torch_soak.py``: the port's
    rig and broker copy, with ``tests/helpers.py`` and ``tests/minis3.py``,
    which import neither package) with only the fleet's run left out; and
    ``chip_smoke.py``'s phase-14 imports run.  No JAX module, nothing of
    the JAX package and none of the reference's test-side modules that
    import it is loaded."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    fixture = os.path.join(REPO, "tests", "fixtures", "incident_bundle_v1.json")
    proc = subprocess.run(
        [sys.executable, "-c", _LAZY_PROBE, fixture,
         ",".join(BANNED + REFERENCE_TEST_MODULES)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    tags = ("PROFILE", "FUZZ", "REPLAY", "WORLD", "CHIP_SMOKE", "BANNED")
    lines = dict(line.split(" ", 1) for line in proc.stdout.splitlines()
                 if line.split(" ", 1)[0] in tags)
    assert lines["PROFILE"] == "downloader_tpu_torch.soak.workload SoakProfile 18"
    world = "downloader_tpu_torch.soak.rig downloader_tpu_torch.soak.workload"
    assert lines["FUZZ"] == "True " + world
    # the empty run breaches nothing, so the replay diverges (exit 1)
    assert lines["REPLAY"] == "1 " + world
    assert "# run 1/1: DIVERGED" in proc.stderr
    assert lines["WORLD"] == ("downloader_tpu_torch.soak.rig test_torch_miniamqp "
                              "downloader_tpu_torch.store.s3 minis3 helpers")
    assert int(lines["CHIP_SMOKE"].split()[0]) > 0
    assert lines["BANNED"] == "[]", lines["BANNED"]
