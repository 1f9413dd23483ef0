"""Staging hot-path rules: the zero-copy ratchet's invariants.

- **second-pass-read**: the staging pipeline's contract after the
  hash-on-land work is ONE read pass per staged byte — the digest is
  computed at the landing moment (bytes hot in page cache) and carried
  on ``job.landed_digests`` / the fs store's etag memo.  Any new
  ``md5_file_hex`` / ``multipart_etag_hex`` call (or an open-and-hash
  read loop) on a stages/store module re-introduces the full-file
  second read the ratchet just retired.  The blessed sites (the
  landing-site hash itself, the memo-miss fallback, the resume probe
  that has no landed digest to trust) carry justified suppressions.
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, ModuleSource, module_checker

#: the shared full-file hashing helpers (utils/hashing.py) — each call
#: is, by definition, one complete read pass over the file
_REREAD_HELPERS = frozenset({"md5_file_hex", "multipart_etag_hex"})

#: rule scope: the staging hot path — bytes land in stages/ and are
#: spilled/fetched by store/.  Other packages (control, fleet, cli,
#: tests, bench) hash small metadata where a second pass is noise.
_HOT_PREFIXES = ("downloader_tpu_torch/stages/", "downloader_tpu_torch/store/")


def _expr_helper(expr: ast.expr) -> str:
    """The re-read helper a Name/Attribute expression refers to, or ''."""
    if isinstance(expr, ast.Name) and expr.id in _REREAD_HELPERS:
        return expr.id
    if isinstance(expr, ast.Attribute) and expr.attr in _REREAD_HELPERS:
        return expr.attr
    return ""


def _loop_hashes_reads(loop: ast.stmt) -> bool:
    """True for a loop body that both ``.read()``s and ``.update()``s —
    the shape of a hand-rolled hash-the-whole-file pass."""
    reads = updates = False
    for node in ast.walk(loop):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            if node.func.attr == "read":
                reads = True
            elif node.func.attr == "update":
                updates = True
        if reads and updates:
            return True
    return False


@module_checker(
    "second-pass-read",
    "A full-file re-read (md5_file_hex / multipart_etag_hex, or an "
    "open-and-hash read loop) on the staging hot path (stages/, "
    "store/): the hash-on-land contract is ONE read pass per staged "
    "byte — the landing-site digest rides job.landed_digests and the "
    "fs store's etag memo, so a new full read pass is a cpu_s_per_gb "
    "regression.  Legitimately unavoidable passes (no landed digest "
    "exists) take a justified suppression.")
def check_second_pass_read(module: ModuleSource) -> List[Finding]:
    rel = module.rel_path.replace("\\", "/")
    if module.profile != "library" or not rel.startswith(_HOT_PREFIXES):
        return []
    out = []
    for node in module.nodes:
        if isinstance(node, ast.Call):
            # direct call, or the helper handed to a thread offloader
            # (asyncio.to_thread(md5_file_hex, ...) /
            # run_in_executor(pool, md5_file_hex, ...)) — the pass runs
            # either way, just on another thread
            helper = _expr_helper(node.func)
            if not helper:
                for arg in node.args:
                    helper = _expr_helper(arg)
                    if helper:
                        break
            if helper:
                out.append(Finding(
                    "second-pass-read", module.rel_path, node.lineno,
                    f"{helper}() re-reads the whole file on the staging "
                    "hot path — use the landed digest "
                    "(job.landed_digests / the store's etag memo), or "
                    "justify the pass with a suppression"))
        elif isinstance(node, (ast.While, ast.For)):
            if _loop_hashes_reads(node):
                out.append(Finding(
                    "second-pass-read", module.rel_path, node.lineno,
                    "hand-rolled read()+update() hashing loop on the "
                    "staging hot path — hash at the landing write "
                    "instead (hash-on-land), or justify the pass"))
    return out
