"""The port's copy of the service is the reference's service.

Every module the port copies from ``downloader_tpu`` must have the
reference's syntax tree once docstrings are dropped and the package name
is mapped (``downloader_tpu`` -> ``downloader_tpu_torch`` in imports and
string constants); comments may differ.  So the reference's own service
tests vouch for the copies, and the port's suite mirrors only the
modules listed in :data:`DIFFERS`, each beside its reason and its mirror
tests.  The generated ``schemas/downloader_pb2.py`` is compared byte for
byte (protobuf registers the file in one process-wide descriptor pool,
where only an identical copy can sit beside the reference's), and its
``.proto`` line for line outside its ``//`` comments.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "downloader_tpu")
PORT = os.path.join(REPO, "downloader_tpu_torch")

# what the port does not copy: the JAX compute plane (ported by hand),
# the soak harness and graftlint (outside the service), and the operator
# CLI (the port's cli.py is its own; the operator commands come later)
NOT_COPIED_DIRS = ("compute", "soak", "analysis")
NOT_COPIED_FILES = ("cli.py",)

# the reference's framework-free compute helpers the port copies
COMPUTE_COPIES = ("compute/video.py", "compute/transcode.py",
                  "compute/parallel/transfer.py")

# copies that differ from the reference, each with its reason and the
# tests that hold it instead
DIFFERS = {
    "__init__.py": (
        "adds resolve_device (the card unless the CPU is asked for); "
        "installs the same compat backports at import",
        "tests/test_torch_pipeline.py::test_default_device_is_cuda_and_never_falls_back, "
        "tests/test_torch_stage.py::test_port_package_installs_compat_backports"),
    "__main__.py": (
        "runs the service with no arguments, as the reference's does, and "
        "the port's upscale/train CLI with a subcommand",
        "tests/test_torch_isolation.py::test_service_entry_point_serves_and_stops"),
    "stages/upscale.py": (
        "runs the port's FrameUpscaler: the device knob, use_mesh and donate "
        "read but not passed, the engine built inside the compute seam",
        "tests/test_torch_stage.py"),
}

SERVICE = sorted(
    os.path.relpath(os.path.join(root, name), REF)
    for root, dirs, files in os.walk(REF)
    for name in files
    if name.endswith((".py", ".proto"))
    and not os.path.relpath(root, REF).split(os.sep)[0] in NOT_COPIED_DIRS
    and os.path.relpath(os.path.join(root, name), REF) not in NOT_COPIED_FILES)
COPIES = [rel for rel in SERVICE + list(COMPUTE_COPIES)
          if rel.endswith(".py") and not rel.endswith("_pb2.py")
          and rel not in DIFFERS]
GENERATED = [rel for rel in SERVICE if rel.endswith("_pb2.py")]
PROTOS = [rel for rel in SERVICE if rel.endswith(".proto")]


def _rename(text: str) -> str:
    return re.sub(r"\bdownloader_tpu\b", "downloader_tpu_torch", text)


def _tree(path: str, reference: bool) -> str:
    """The module's AST without docstrings, the reference's renamed."""
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)
                    and isinstance(body[0].value.value, str)):
                node.body = body[1:] or [ast.Pass()]
        if not reference:
            continue
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            node.value = _rename(node.value)
        elif isinstance(node, ast.ImportFrom) and node.module:
            node.module = _rename(node.module)
        elif isinstance(node, ast.alias):
            node.name = _rename(node.name)
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_reference(rel):
    port = os.path.join(PORT, rel)
    assert os.path.exists(port), f"{rel} is not copied into the port"
    assert _tree(port, reference=False) == _tree(os.path.join(REF, rel),
                                                 reference=True), (
        f"downloader_tpu_torch/{rel} differs from the reference beyond "
        "docstrings and the package name; list it in DIFFERS with its "
        "reason and a mirror test, or copy it again")


@pytest.mark.parametrize("rel", GENERATED)
def test_generated_schema_is_byte_identical(rel):
    with open(os.path.join(REF, rel), "rb") as ref, \
            open(os.path.join(PORT, rel), "rb") as port:
        assert port.read() == ref.read()


def _proto_code(path: str) -> list:
    with open(path, encoding="utf-8") as fh:
        return [line.split("//", 1)[0].rstrip() for line in fh]


@pytest.mark.parametrize("rel", PROTOS)
def test_schema_source_matches_outside_comments(rel):
    assert _proto_code(os.path.join(PORT, rel)) == _proto_code(
        os.path.join(REF, rel))


def test_every_service_module_is_copied_or_listed():
    missing = [rel for rel in SERVICE
               if not os.path.exists(os.path.join(PORT, rel))]
    assert missing == []
    assert set(DIFFERS) <= set(SERVICE)
    for rel, (reason, mirrors) in DIFFERS.items():
        assert reason and mirrors
        for mirror in mirrors.split(", "):
            path = mirror.split("::")[0]
            assert os.path.exists(os.path.join(REPO, path)), mirror


def test_listed_modules_really_differ():
    """A module listed as differing that has become a plain copy again
    belongs under the copy check, not in the list."""
    for rel in DIFFERS:
        assert _tree(os.path.join(PORT, rel), reference=False) != _tree(
            os.path.join(REF, rel), reference=True), rel


@pytest.mark.parametrize("stage", ["download", "process", "upload", "upscale"])
def test_port_stage_registry_names_port_modules(stage):
    """The registry's module names are strings the package rename must
    reach: left alone, the port's service would load the reference's
    stages, and with ``upscale`` the JAX engine."""
    from downloader_tpu_torch.stages import base

    assert base._REGISTRY[stage] == f"downloader_tpu_torch.stages.{stage}"
    factory = base.get_stage_factory(stage)
    assert factory.__module__ == f"downloader_tpu_torch.stages.{stage}"
