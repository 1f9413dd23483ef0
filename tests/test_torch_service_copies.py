"""The port's copy of the service is the reference's service.

Every module the port copies from ``downloader_tpu`` (the service and
the soak harness, ``soak/``) must have the reference's syntax tree once
docstrings are dropped and the package name is mapped
(``downloader_tpu`` -> ``downloader_tpu_torch`` in imports and string
constants); comments may differ.  So the reference's own service and
soak tests vouch for the copies, and the port's suite mirrors only the
modules listed in :data:`DIFFERS`, each beside its reason and its mirror
tests.  The generated ``schemas/downloader_pb2.py`` is compared byte for
byte (protobuf registers the file in one process-wide descriptor pool,
where only an identical copy can sit beside the reference's), and its
``.proto`` line for line outside its ``//`` comments.

graftlint (``analysis/``) is the reference's too: its modules are copies
but ``core.py`` (the port's walk and file profiles) and two rule modules
whose rule docs leave out the reference project's history, which are
held definition by definition with each exception in
:data:`ANALYSIS_DIFFERS`.  ``tests/test_torch_analysis.py`` holds every
definition of ``tests/test_analysis.py``, plus the tests that hold the
two registries against each other.

``cli.py`` is held function by function: every top-level function of
the reference's has a counterpart of the same tree in the port's, but
those in :data:`CLI_DIFFERS` (the compute commands and the incident
replay's world).  The port's test-side world is held too: its broker,
``tests/test_torch_miniamqp.py``, is ``tests/miniamqp.py`` on the port's
wire codec plus its own tests, and every definition of
``tests/test_torch_soak.py`` is the one of ``tests/test_soak.py``.
"""

import ast
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(REPO, "downloader_tpu")
PORT = os.path.join(REPO, "downloader_tpu_torch")
TESTS = os.path.join(REPO, "tests")

# what the port does not copy whole: the JAX compute plane (ported by
# hand), cli.py (held function by function below) and three graftlint
# modules (held definition by definition below)
NOT_COPIED_DIRS = ("compute",)
NOT_COPIED_FILES = ("cli.py",)
ANALYSIS_BY_DEFINITION = ("analysis/core.py", "analysis/asynchrony.py",
                          "analysis/drift.py")

# the reference's framework-free compute helpers the port copies
COMPUTE_COPIES = ("compute/video.py", "compute/transcode.py",
                  "compute/overlap_probe.py")
# the reference's compute helpers the port holds but has changed (each
# in DIFFERS)
COMPUTE_DIFFERS = ("compute/parallel/transfer.py",)

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
        "runs the port's FrameUpscaler: the device knob, use_mesh passed "
        "(every visible card), donate read but not passed, the engine built "
        "inside the compute seam; its checkpoint restored by the port's "
        "restore_state, which reads the port's steps and the JAX package's "
        "orbax steps",
        "tests/test_torch_stage.py, "
        "tests/test_torch_orbax.py::test_service_stage_serves_a_jax_checkpoint"),
    "compute/parallel/transfer.py": (
        "HopSink names its layer and timed_hop marks the block on the torch "
        "profiler's timeline as host.<layer>.<hop>, bills bytes a block "
        "learns as it runs, and reads no clock with neither a sink bound "
        "nor a profiler recording; timed_next bills a read",
        "tests/test_torch_hops.py, "
        "tests/test_torch_threads.py::test_engine_bills_three_hops_on_the_cpu"),
    "incident/fuzz.py": (
        "_replay_variant builds the port's soak world (tests/test_torch_soak.py), "
        "never the reference's test_soak, whose rig runs the JAX package's "
        "workers",
        "tests/test_torch_isolation.py::test_lazy_paths_import_no_jax_or_reference"),
}

# top-level functions of the port's cli.py that differ from the
# reference's, each with its reason and the tests that hold it instead
CLI_DIFFERS = {
    "_build_parser": (
        "the upscale/train subparsers: the GPU's help texts and --device "
        "(compared with those statements left out); the program's name",
        "tests/test_torch_cli.py, tests/test_torch_pipeline.py::"
        "test_cli_upscale_on_cpu_matches_engine"),
    "_upscale": (
        "the port's FrameUpscaler on --device; no optional-extra fallback",
        "tests/test_torch_pipeline.py::test_cli_upscale_on_cpu_matches_engine, "
        "tests/test_torch_pipeline.py::test_cli_decode_encode_round_trip"),
    "_train": (
        "the port's trainer on --device",
        "tests/test_torch_trainer.py::test_cli_train_and_upscale"),
    "_incident_replay": (
        "imports the port's SoakTestWorld (tests/test_torch_soak.py), never "
        "the reference's test_soak",
        "tests/test_torch_isolation.py::test_lazy_paths_import_no_jax_or_reference, "
        "tests/test_torch_cli.py::test_incident_replay_compile_only"),
}

# top-level definitions of those graftlint modules that differ from the
# reference's, each with its reason and the tests that hold it instead
_DOC_REASON = ("the rule's doc is the reference's without its closing "
               "remark on the reference project's history; the rule is "
               "the reference's")
_DOC_MIRRORS = ("tests/test_torch_analysis.py::"
                "test_registries_hold_the_same_rules, "
                "tests/test_torch_analysis.py::"
                "test_registries_agree_on_every_file_where_profiles_agree")
ANALYSIS_DIFFERS = {
    "analysis/core.py:DEFAULT_TARGETS": (
        "the port's walk: its package, tests/test_torch_*.py and "
        "chip_smoke.py; the reference's trees are the reference gate's",
        "tests/test_torch_lint.py::test_walk_covers_the_expected_tree"),
    "analysis/core.py:_CLI_BASENAMES": (
        "graft_entry.py and chip_smoke.py are CLIs, as the reference's "
        "__graft_entry__.py is",
        "tests/test_torch_lint.py::test_port_entry_points_and_spikes_print, "
        "tests/test_torch_analysis.py::"
        "test_registries_agree_on_every_file_where_profiles_agree"),
    "analysis/core.py:file_profile": (
        "downloader_tpu_torch/scripts/ is a script, as the root scripts/ is",
        "tests/test_torch_lint.py::test_port_entry_points_and_spikes_print, "
        "tests/test_torch_analysis.py::"
        "test_registries_agree_on_every_file_where_profiles_agree"),
    "analysis/core.py:iter_source_files": (
        "a target holding a glob character stands for what it matches "
        "(tests/test_torch_*.py)",
        "tests/test_torch_lint.py::test_walk_covers_the_expected_tree"),
    "analysis/asynchrony.py:check_ack_settle": (_DOC_REASON, _DOC_MIRRORS),
    "analysis/asynchrony.py:check_unbounded_timeout": (_DOC_REASON,
                                                       _DOC_MIRRORS),
    "analysis/drift.py:check_event_drift": (_DOC_REASON, _DOC_MIRRORS),
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
          and rel not in DIFFERS and rel not in ANALYSIS_BY_DEFINITION]
GENERATED = [rel for rel in SERVICE if rel.endswith("_pb2.py")]
PROTOS = [rel for rel in SERVICE if rel.endswith(".proto")]


def _rename(text: str) -> str:
    return re.sub(r"\bdownloader_tpu\b", "downloader_tpu_torch", text)


def _tree(path: str, reference: bool) -> str:
    """The module's AST without docstrings, the reference's renamed."""
    return ast.dump(_parsed(path, reference))


def _parsed(path: str, reference: bool) -> ast.Module:
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
    return tree


def _defs(path: str, reference: bool) -> dict:
    """Top-level functions and classes by name, each as its tree."""
    return {node.name: node for node in _parsed(path, reference).body
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef))}


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
    assert set(DIFFERS) <= set(SERVICE) | set(COMPUTE_DIFFERS)
    for rel, (reason, mirrors) in DIFFERS.items():
        assert reason and mirrors
        for mirror in mirrors.split(", "):
            path = mirror.split("::")[0]
            assert os.path.exists(os.path.join(REPO, path)), mirror


REF_CLI = _defs(os.path.join(REF, "cli.py"), reference=True)
PORT_CLI = _defs(os.path.join(PORT, "cli.py"), reference=False)


@pytest.mark.parametrize("name", sorted(set(REF_CLI) - set(CLI_DIFFERS)))
def test_cli_function_matches_reference(name):
    assert name in PORT_CLI, f"cli.py: {name} is not ported"
    assert ast.dump(PORT_CLI[name]) == ast.dump(REF_CLI[name]), (
        f"downloader_tpu_torch/cli.py: {name} differs from the reference "
        "beyond docstrings and the package name; list it in CLI_DIFFERS "
        "with its reason and a mirror test, or copy it again")


def test_cli_differs_are_listed_and_real():
    """The port's CLI defines exactly the reference's functions, and each
    listed exception really differs and names existing mirror tests."""
    assert set(PORT_CLI) == set(REF_CLI)
    for name, (reason, mirrors) in CLI_DIFFERS.items():
        assert reason and ast.dump(PORT_CLI[name]) != ast.dump(REF_CLI[name])
        for mirror in mirrors.split(", "):
            assert os.path.exists(os.path.join(REPO, mirror.split("::")[0]))


def _parser_body(fn: ast.FunctionDef) -> list:
    """``_build_parser``'s statements without the upscale/train
    subparsers and with the program's name left out."""
    body = []
    for stmt in fn.body:
        names = {node.id for node in ast.walk(stmt)
                 if isinstance(node, ast.Name)}
        if names & {"upscale", "train"}:
            continue
        for node in ast.walk(stmt):
            if isinstance(node, ast.keyword) and node.arg == "prog":
                node.value = ast.Constant(None)
        body.append(ast.dump(stmt))
    return body


def test_cli_parser_matches_reference_but_upscale_and_train():
    """Every operator command's parser is the reference's: the port's
    ``_build_parser`` differs only in the upscale/train subparsers."""
    port, ref = PORT_CLI["_build_parser"], REF_CLI["_build_parser"]
    assert _parser_body(port) == _parser_body(ref)
    commands = {stmt.value.args[0].value for stmt in port.body
                if isinstance(stmt, ast.Assign)
                and isinstance(stmt.value, ast.Call)
                and getattr(stmt.value.func, "attr", None) == "add_parser"
                and isinstance(stmt.value.func.value, ast.Name)
                and stmt.value.func.value.id == "sub"}
    assert commands == {
        "submit", "mktorrent", "magnet", "scrape", "status", "jobs", "fleet",
        "trace", "tenants", "incident", "debug", "scrub", "watch", "upscale",
        "train"}



def test_port_broker_is_the_reference_broker():
    """``tests/test_torch_miniamqp.py`` is ``tests/miniamqp.py`` on the
    port's wire codec, followed by its own tests only."""
    ref = _parsed(os.path.join(TESTS, "miniamqp.py"), reference=True).body
    port = _parsed(os.path.join(TESTS, "test_torch_miniamqp.py"),
                   reference=False).body
    assert [ast.dump(node) for node in port[:len(ref)]] == [
        ast.dump(node) for node in ref]
    extra = port[len(ref):]
    assert extra and all(isinstance(node, ast.FunctionDef)
                         and node.name.startswith("test_") for node in extra)


def test_port_soak_world_is_the_reference_world():
    """Every definition of ``tests/test_torch_soak.py`` (the origins, the
    world, the smoke) is the one of ``tests/test_soak.py`` of that name."""
    ref = _defs(os.path.join(TESTS, "test_soak.py"), reference=True)
    port = _defs(os.path.join(TESTS, "test_torch_soak.py"), reference=False)
    assert {"SoakTestWorld", "test_soak_smoke"} <= set(port)
    for name, node in port.items():
        assert ast.dump(node) == ast.dump(ref[name]), name


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


def _statements(path: str, reference: bool) -> list:
    """Top-level statements in order as (name, tree): a definition or a
    one-name assignment by its name, anything else by its tree."""
    out = []
    for node in _parsed(path, reference).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            name = node.name
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            name = node.target.id
        else:
            name = ast.dump(node)
        out.append((name, node))
    return out


@pytest.mark.parametrize("rel", ANALYSIS_BY_DEFINITION)
def test_analysis_module_matches_reference_but_listed(rel):
    """The module has the reference's statements in the reference's
    order; each is the reference's, but those in ANALYSIS_DIFFERS, and
    each of those really differs."""
    port = _statements(os.path.join(PORT, rel), reference=False)
    ref = _statements(os.path.join(REF, rel), reference=True)
    assert [name for name, _ in port] == [name for name, _ in ref]
    for (name, node), (_, want) in zip(port, ref):
        listed = f"{rel}:{name}" in ANALYSIS_DIFFERS
        assert (ast.dump(node) != ast.dump(want)) == listed, (
            f"downloader_tpu_torch/{rel}: {name} "
            + ("is the reference's again; take it out of ANALYSIS_DIFFERS"
               if listed else "differs from the reference; list it in "
               "ANALYSIS_DIFFERS with its reason and a mirror test"))


def test_analysis_differs_are_listed_with_mirrors():
    for key, (reason, mirrors) in ANALYSIS_DIFFERS.items():
        rel, name = key.split(":")
        assert rel in ANALYSIS_BY_DEFINITION and reason
        assert name in dict(_statements(os.path.join(PORT, rel), False))
        for mirror in mirrors.split(", "):
            path, test = mirror.split("::")
            with open(os.path.join(REPO, path), encoding="utf-8") as fh:
                assert f"def {test}(" in fh.read(), mirror


def _words(text: str) -> list:
    return re.findall(r"\w+", text)


@pytest.mark.parametrize("key", sorted(
    key for key, (reason, _) in ANALYSIS_DIFFERS.items()
    if reason == _DOC_REASON))
def test_analysis_rule_differs_only_in_its_doc(key):
    """A checker listed for its doc is the reference's checker with the
    reference's doc in place, and its doc is the reference's with words
    left out."""
    rel, name = key.split(":")
    port = dict(_statements(os.path.join(PORT, rel), False))[name]
    ref = dict(_statements(os.path.join(REF, rel), True))[name]
    port_doc = port.decorator_list[0].args[1]
    ref_doc = ref.decorator_list[0].args[1]
    kept = iter(_words(ref_doc.value))
    assert all(word in kept for word in _words(port_doc.value))
    port.decorator_list[0].args[1] = ref_doc
    assert ast.dump(port) == ast.dump(ref)


def test_port_analysis_tests_are_the_reference_tests():
    """Every definition of ``tests/test_analysis.py`` is the one of that
    name in ``tests/test_torch_analysis.py``, in its order; the port adds
    only imports, constants and the tests of the two registries."""
    ref = _statements(os.path.join(TESTS, "test_analysis.py"), True)
    port = _statements(os.path.join(TESTS, "test_torch_analysis.py"), False)
    ref_names = dict(ref)
    assert [name for name, _ in port if name in ref_names] == [
        name for name, _ in ref]
    for name, node in port:
        if name in ref_names:
            assert ast.dump(node) == ast.dump(ref_names[name]), name
        else:
            assert isinstance(node, (ast.Import, ast.ImportFrom,
                                     ast.Assign, ast.FunctionDef)), name
    added = [name for name, node in port if name not in ref_names
             and isinstance(node, ast.FunctionDef)
             and name.startswith("test_")]
    assert "test_registries_agree_on_every_file_where_profiles_agree" in added
