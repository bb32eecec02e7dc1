"""AST-based repository lint: enforce the port's own codebase contracts.

A copy of ``repro.analysis.repolint`` for ``repro_torch``: the same four
rules, scopes and messages, with the port's own fence in RL003.  It checks
statically (``make lint-repro``), so a violation fails before any test
runs:

``RL001`` deprecated-shim
    No internal call to the deprecated ``run_layer`` / ``run_stack``
    shims.  The port carries neither; the rule keeps them from coming
    back.  (The suffix-named per-schedule entry points — ``run_layer_fused``
    etc. — are the supported API and are not flagged.)

``RL002`` serving-assert
    No bare ``assert`` statement, and no ``raise RuntimeError(...)`` /
    ``raise AssertionError(...)``, on the serving path (``dispatch/``,
    ``rnn/``, ``serving/``).  Faults there must use the structured
    ``runtime.errors`` taxonomy so callers can quarantine by slot/uid —
    and ``assert`` vanishes under ``python -O``, which would silently
    drop the check in an optimized deployment.

``RL003`` timing-outside-obs
    No ``time.*`` calls, no ``torch.cuda.synchronize`` (the port's
    counterpart of ``jax.block_until_ready``) and no ``torch.cuda.Event``
    outside ``runtime/obs.py`` (scope: ``calib/``, ``dispatch/``,
    ``rnn/``, ``serving/``, ``runtime/``).  Timing and fencing go through
    the obs module's ``measure_samples`` / ``measure_us`` /
    ``monotonic_s`` / ``fence``, so every measurement shares one fenced
    clock — the calibration replay included.  Launch-side modules (``launch/``) legitimately stamp
    wall-clock metadata and fence a served batch, and are out of scope.

``RL004`` slot-field-read
    ``Slot.signature()``-relevant fields (``wave``, ``chunk_len``,
    ``group_b``, ``chained``, ``tile_k``, ``mvm_block``) are read only by
    the planner, the executor, the verifier (``analysis/``),
    ``runtime/obs.py``, and the calibration subsystem (``calib/``).  Any
    other module pattern-matching on slot internals is coupling to the
    packing layout, which the planner is free to change under the same
    ``signature()``.

Usage::

    python -m repro_torch.analysis.repolint src/repro_torch  # make lint-repro
    violations = collect(Path("src/repro_torch"))            # programmatic

Paths are keyed by their suffix after the last ``repro_torch`` path
component, so the rules apply identically from a checkout root, an
installed site-packages tree, or a test's tmp dir.
"""
from __future__ import annotations

import ast
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

#: the package directory whose suffix keys the rule scopes
PACKAGE = "repro_torch"

#: the deprecated entry points RL001 bans (exact names; the per-schedule
#: ``run_layer_*`` functions are the supported replacements)
DEPRECATED_SHIMS = ("run_layer", "run_stack")

#: exception constructors RL002 bans on the serving path
BANNED_RAISES = ("RuntimeError", "AssertionError")

#: dotted-name suffixes RL003 bans as fences or device clocks (the bare
#: ``synchronize`` covers ``from torch.cuda import synchronize``)
FENCES = ("cuda.synchronize", "cuda.Event")

#: Slot fields whose reads RL004 confines to planner/executor/analysis.
#: ("groups" is signature-relevant too but collides with ``m.groups()``
#: on regex matches — the planner's own property tests cover it.)
SLOT_FIELDS = frozenset(
    {"wave", "chunk_len", "group_b", "chained", "tile_k", "mvm_block"})

#: rule -> (path prefixes in scope, path suffixes exempt).  "" = repo-wide.
_SCOPES = {
    "RL001": (("",), ("core/schedules.py", "core/gru.py")),
    "RL002": (("dispatch/", "rnn/", "serving/"), ()),
    "RL003": (("calib/", "dispatch/", "rnn/", "serving/", "runtime/"),
              ("runtime/obs.py",)),
    "RL004": (("",), ("dispatch/planner.py", "dispatch/executor.py",
                      "runtime/obs.py", "analysis/", "calib/")),
}


@dataclass(frozen=True)
class Violation:
    rule: str       # "RL001".."RL004"
    path: str       # repo-relative path of the offending file
    line: int       # 1-based source line
    msg: str        # what was found and what to use instead

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


def _relkey(relpath: str) -> str:
    """Key a path by its suffix after the last ``repro_torch`` component,
    so scope prefixes match regardless of checkout layout."""
    parts = Path(relpath).as_posix().split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return "/".join(parts[i + 1:])
    return "/".join(parts)


def _in_scope(rule: str, key: str) -> bool:
    prefixes, exempt = _SCOPES[rule]
    for e in exempt:
        if key == e or (e.endswith("/") and key.startswith(e)):
            return False
    return any(key.startswith(p) for p in prefixes)


def _callee_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """'time.monotonic' for Attribute chains rooted at a Name."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_clock(dotted: str) -> bool:
    return (dotted.startswith("time.") or dotted == "synchronize"
            or any(dotted == f or dotted.endswith("." + f) for f in FENCES))


class _Linter(ast.NodeVisitor):
    def __init__(self, key: str, path: str):
        self.key = key
        self.path = path
        self.out: List[Violation] = []

    def _emit(self, rule: str, line: int, msg: str) -> None:
        if _in_scope(rule, self.key):
            self.out.append(Violation(rule, self.path, line, msg))

    # -- RL002: bare assert -------------------------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        self._emit("RL002", node.lineno,
                   "bare `assert` on the serving path — raise a "
                   "runtime.errors fault (asserts vanish under -O)")
        self.generic_visit(node)

    # -- RL002: raise RuntimeError/AssertionError ---------------------------
    def visit_Raise(self, node: ast.Raise) -> None:
        exc = node.exc
        name = None
        if isinstance(exc, ast.Call):
            name = _callee_name(exc)
        elif isinstance(exc, (ast.Name, ast.Attribute)):
            name = exc.id if isinstance(exc, ast.Name) else exc.attr
        if name in BANNED_RAISES:
            self._emit("RL002", node.lineno,
                       f"raise {name} on the serving path — use the "
                       "runtime.errors taxonomy (ServingFault subclass)")
        self.generic_visit(node)

    # -- RL001 / RL003: calls -----------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _callee_name(node)
        if name in DEPRECATED_SHIMS:
            self._emit("RL001", node.lineno,
                       f"call to deprecated shim `{name}` — use the "
                       "repro_torch.rnn facade (compile/forward)")
        dotted = _dotted(node.func)
        if dotted is not None and _is_clock(dotted):
            self._emit(
                "RL003", node.lineno,
                f"`{dotted}` outside runtime/obs.py — time/fence via "
                "obs.measure_us / obs.monotonic_s / obs.fence")
        self.generic_visit(node)

    # -- RL004: slot-field reads --------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (isinstance(node.ctx, ast.Load) and node.attr in SLOT_FIELDS
                and not (isinstance(node.value, ast.Name)
                         and node.value.id == "self")):
            self._emit(
                "RL004", node.lineno,
                f"read of Slot packing field `.{node.attr}` outside "
                "planner/executor/analysis — go through DispatchPlan's "
                "public surface")
        self.generic_visit(node)


def lint_source(src: str, relpath: str) -> List[Violation]:
    """Lint one file's source text.  ``relpath`` decides rule scope (it
    is keyed by its suffix after the last ``repro_torch`` component)."""
    key = _relkey(relpath)
    tree = ast.parse(src, filename=relpath)
    linter = _Linter(key, relpath)
    linter.visit(tree)
    return sorted(linter.out, key=lambda v: (v.path, v.line, v.rule))


def collect(root: Path) -> List[Violation]:
    """Lint every ``*.py`` under ``root``; returns sorted violations."""
    out: List[Violation] = []
    for path in sorted(Path(root).rglob("*.py")):
        out.extend(lint_source(path.read_text(), str(path)))
    return sorted(out, key=lambda v: (v.path, v.line, v.rule))


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    roots = [Path(a) for a in args] or [Path("src/repro_torch")]
    violations: List[Violation] = []
    for root in roots:
        if not root.exists():
            print(f"repolint: no such path: {root}", file=sys.stderr)
            return 2
        violations.extend(collect(root))
    for v in violations:
        print(v)
    n = len(violations)
    root_names = ", ".join(str(r) for r in roots)
    if n:
        print(f"repolint: {n} violation(s) in {root_names}",
              file=sys.stderr)
        return 1
    print(f"repolint: clean ({root_names})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["Violation", "lint_source", "collect", "main", "PACKAGE",
           "DEPRECATED_SHIMS", "BANNED_RAISES", "FENCES", "SLOT_FIELDS"]
