"""Generic eslint/ruff-parity rules.

The lint checks of the service's upstream, in the graftlint registry so
the repo has ONE checker framework: unused imports (F401), bare ``except`` (E722), tabs,
``print()`` in library code, mutable default arguments (B006),
f-strings without placeholders (F541), ``== None/True/False``
(E711/E712), ``is`` against literals (F632), ``raise NotImplemented``
(F901), same-scope redefinition (F811), and discarded ``create_task``
results (RUF006).

The only escape is a graftlint suppression (which requires a
justification); ``# noqa`` is honored by no rule here.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, ModuleSource, module_checker


@module_checker(
    "tabs",
    "Tab characters in source (the tree is spaces-indented everywhere).")
def check_tabs(module: ModuleSource) -> List[Finding]:
    out = []
    for lineno, line in enumerate(module.lines, start=1):
        if "\t" in line:
            out.append(Finding("tabs", module.rel_path, lineno,
                               "tab character in source"))
    return out


class _ImportUsage(ast.NodeVisitor):
    def __init__(self):
        self.imported = {}  # name -> lineno
        self.used = set()

    def visit_Import(self, node):
        for alias in node.names:
            name = (alias.asname or alias.name).split(".")[0]
            self.imported[name] = node.lineno

    def visit_ImportFrom(self, node):
        if node.module == "__future__":
            return
        for alias in node.names:
            if alias.name == "*":
                continue
            self.imported[alias.asname or alias.name] = node.lineno

    def visit_Name(self, node):
        self.used.add(node.id)

    def visit_Attribute(self, node):
        self.generic_visit(node)


@module_checker(
    "unused-import",
    "Imported name never referenced and not re-exported via __all__ "
    "(F401).")
def check_unused_imports(module: ModuleSource) -> List[Finding]:
    usage = _ImportUsage()
    usage.visit(module.tree)
    explicit_exports = set()
    for node in module.nodes:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    for elt in getattr(node.value, "elts", []):
                        if isinstance(elt, ast.Constant):
                            explicit_exports.add(elt.value)
    out = []
    for name, line in sorted(usage.imported.items(),
                             key=lambda item: item[1]):
        if (name in usage.used or name in explicit_exports
                or name.startswith("_")):
            continue
        out.append(Finding("unused-import", module.rel_path, line,
                           f"unused import: {name}"))
    return out


@module_checker(
    "bare-except",
    "Bare 'except:' catches SystemExit/KeyboardInterrupt and — in async "
    "code — CancelledError (E722); name the exception class.")
def check_bare_except(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            out.append(Finding("bare-except", module.rel_path, node.lineno,
                               "bare 'except:'"))
    return out


@module_checker(
    "print-in-library",
    "print() in library code — the pipeline logs, it doesn't print "
    "(CLIs, benches, scripts, and tests are exempt by file profile).")
def check_print(module: ModuleSource) -> List[Finding]:
    if module.profile != "library":
        return []
    out = []
    for node in module.nodes:
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "print"):
            out.append(Finding("print-in-library", module.rel_path,
                               node.lineno, "print() in library code"))
    return out


@module_checker(
    "mutable-default",
    "Mutable default argument shared across calls (B006).")
def check_mutable_defaults(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for default in [*node.args.defaults, *node.args.kw_defaults]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                isinstance(default, ast.Call)
                and isinstance(default.func, ast.Name)
                and default.func.id in {"list", "dict", "set"}
            ):
                out.append(Finding(
                    "mutable-default", module.rel_path, node.lineno,
                    f"mutable default argument in {node.name}()"))
    return out


@module_checker(
    "empty-fstring",
    "f-string without placeholders (F541).")
def check_empty_fstrings(module: ModuleSource) -> List[Finding]:
    # format specs (f"{x:.2f}") are themselves JoinedStr nodes with no
    # FormattedValue parts — not user-facing f-strings, don't flag them
    format_specs = {
        id(node.format_spec)
        for node in module.nodes
        if isinstance(node, ast.FormattedValue)
        and node.format_spec is not None
    }
    out = []
    for node in module.nodes:
        if (isinstance(node, ast.JoinedStr)
                and id(node) not in format_specs
                and not any(isinstance(part, ast.FormattedValue)
                            for part in node.values)):
            out.append(Finding("empty-fstring", module.rel_path,
                               node.lineno,
                               "f-string without placeholders"))
    return out


@module_checker(
    "literal-comparison",
    "Equality against None/True/False (use is/is not, E711/E712) or "
    "'is' against a str/number literal (F632).")
def check_literal_comparisons(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if not isinstance(node, ast.Compare):
            continue
        for op, comparator in zip(node.ops, node.comparators):
            if isinstance(op, (ast.Eq, ast.NotEq)) and (
                isinstance(comparator, ast.Constant)
                and (comparator.value is None
                     or comparator.value is True
                     or comparator.value is False)
            ):
                out.append(Finding(
                    "literal-comparison", module.rel_path, node.lineno,
                    "use is/is not for None/True/False"))
            if isinstance(op, (ast.Is, ast.IsNot)) and (
                isinstance(comparator, ast.Constant)
                and isinstance(comparator.value, (str, int, float, bytes))
                and not isinstance(comparator.value, bool)
            ):
                out.append(Finding(
                    "literal-comparison", module.rel_path, node.lineno,
                    "'is' comparison against a literal"))
    return out


@module_checker(
    "raise-notimplemented",
    "raise NotImplemented (the constant) instead of "
    "NotImplementedError (F901).")
def check_raise_notimplemented(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if not isinstance(node, ast.Raise):
            continue
        exc = node.exc
        if isinstance(exc, ast.Call):
            exc = exc.func
        if isinstance(exc, ast.Name) and exc.id == "NotImplemented":
            out.append(Finding(
                "raise-notimplemented", module.rel_path, node.lineno,
                "raise NotImplementedError, not NotImplemented"))
    return out


@module_checker(
    "redefinition",
    "Function redefined in the same scope shadows the first definition "
    "(F811; decorated defs — @property setters, dispatch registrations "
    "— are legitimate).")
def check_redefinition(module: ModuleSource) -> List[Finding]:
    out = []
    for scope in module.nodes:
        if not isinstance(scope, (ast.Module, ast.ClassDef,
                                  ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        seen = {}
        for stmt in getattr(scope, "body", []):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not stmt.decorator_list and stmt.name in seen:
                    out.append(Finding(
                        "redefinition", module.rel_path, stmt.lineno,
                        f"redefinition of {stmt.name}() "
                        f"(first at line {seen[stmt.name]})"))
                seen.setdefault(stmt.name, stmt.lineno)
    return out


@module_checker(
    "discarded-task",
    "create_task() result discarded — the event loop holds only a weak "
    "reference, so the task can be garbage-collected mid-run (RUF006).")
def check_discarded_task(module: ModuleSource) -> List[Finding]:
    out = []
    for node in module.nodes:
        if (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "create_task"):
            out.append(Finding(
                "discarded-task", module.rel_path, node.lineno,
                "create_task() result discarded (task may be GC'd)"))
    return out
