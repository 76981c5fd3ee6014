"""AST lint rules of the port, the counterpart of ``repro.analysis.rules``
(the reference's ``RPR1xx`` catalogue, in torch idiom).

Each rule encodes a hazard that has bitten the reference (or is the
direct software analogue of one that did), so the catalog is deliberately
narrow and repo-specific — this is not a general-purpose linter:

=======  ==================================================================
RPR100   ``# repro: allow[...]`` pragma without a justification string
RPR101   mutable default argument (list/dict/set literal or constructor)
RPR102   shared config instance: a ``*Config(...)`` call as a parameter
         default or bound to a module-level name (in the reference: every ``Server``
         shared one import-time ``ServerConfig()`` default). The
         module-level arm exempts ``configs/`` — the zoo registry is
         frozen ``ModelConfig`` instances by design; the default-argument
         arm applies everywhere.
RPR103   module-level mutable state in ``serving/``: a ``global`` statement
         or a module-scope mutable container (in the reference: the module-global
         ``rid`` counter made fresh servers continue old id sequences)
RPR104   bare ``assert`` in library code — stripped under ``python -O``
         (in the reference: a stripped assert let a double ``finish()`` evict the
         slot's new tenant and double-free its pages)
RPR105   ``torch.from_numpy`` / ``torch.as_tensor`` / ``torch.asarray`` over a
         live numpy mirror (``.page_table`` / ``.seq_lens``) without
         ``.copy()`` in ``serving/``: ``from_numpy`` always shares the
         array's memory (and the others do on the CPU), so a dispatched step
         would alias a mirror the server mutates before the step runs
RPR106   host-sync call (``.item()``, ``.tolist()``, ``.cpu()``,
         ``.numpy()``, ``torch.cuda.synchronize`` or an event's or stream's
         ``.synchronize()``, builtin ``float()``/``int()``) inside a
         function registered in :data:`HOT_PATHS` — dispatch paths must
         never block the stream
=======  ==================================================================

Suppression: append ``# repro: allow[RPRnnn] <reason>`` to the offending
line (or the line directly above it). The reason is mandatory; a pragma
without one is reported as RPR100 and suppresses nothing.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import Path
from typing import Iterable, Iterator

RULES = {
    "RPR100": "suppression pragma missing a justification",
    "RPR101": "mutable default argument",
    "RPR102": "shared import-time config instance",
    "RPR103": "module-level mutable state in serving/",
    "RPR104": "bare assert in library code (stripped under python -O)",
    "RPR105": "torch.from_numpy/as_tensor/asarray over a live numpy mirror without .copy()",
    "RPR106": "host sync inside a registered hot path",
}

# Functions whose bodies sit on the dispatch/step critical path: the server
# keeps the card fed by never blocking inside these (the stream boundary
# is EngineCore.harvest_one, which is deliberately NOT registered). Keyed
# by posix path suffix -> function names (methods match by bare name).
HOT_PATHS: dict[str, frozenset[str]] = {
    "repro_torch/serving/engine.py": frozenset(
        {"dispatch_prefill", "dispatch_prefill_batch", "dispatch_decode"}
    ),
    "repro_torch/serving/sampling.py": frozenset({"filter_logits", "sample_logits"}),
    "repro_torch/models/transformer.py": frozenset(
        {"prefill_cb", "_prefill_cb_batched", "decode_cb", "verify_cb"}
    ),
}

# Host mirrors of device-visible serving state (see StateStore): the arrays
# the scheduler mutates in place between dispatches.
_MIRROR_ATTRS = frozenset({"page_table", "seq_lens"})

_MUTABLE_CONSTRUCTORS = frozenset(
    {"dict", "list", "set", "defaultdict", "deque", "OrderedDict", "Counter"}
)

# Calls that wait for the card: a tensor's .item(), .tolist(), .cpu() and
# .numpy(), torch.cuda.synchronize() and an event's or stream's
# .synchronize().
_SYNC_CALLS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
# The torch functions that may wrap a numpy array without copying it.
_NUMPY_WRAPPERS = frozenset({"from_numpy", "as_tensor", "asarray"})

_ALLOW_RE = re.compile(r"#\s*repro:\s*allow\[(RPR\d{3})\]\s*(.*?)\s*$")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


def _call_name(node: ast.AST) -> str | None:
    """Trailing name of a call target: ``a.b.c(...)`` -> ``c``."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_mutable_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return _call_name(node.func) in _MUTABLE_CONSTRUCTORS
    return False


def _is_config_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = _call_name(node.func)
    return bool(name) and name.endswith("Config")


def _ends_in_copy(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "copy"
    )


class _Visitor(ast.NodeVisitor):
    def __init__(self, path: str, hot_functions: frozenset[str],
                 in_serving: bool, in_configs: bool = False):
        self.path = path
        self.hot_functions = hot_functions
        self.in_serving = in_serving
        self.in_configs = in_configs
        self.findings: list[Finding] = []
        self._depth = 0  # 0 = module scope
        self._hot_depth = 0  # > 0 while inside a registered hot function

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(rule, self.path, node.lineno, node.col_offset, message)
        )

    # -- function scopes ----------------------------------------------------
    def _visit_function(self, node) -> None:
        args = node.args
        defaults = list(args.defaults) + list(args.kw_defaults)
        for d in defaults:
            if d is None:
                continue
            if _is_mutable_literal(d):
                self._emit(
                    "RPR101", d,
                    f"mutable default in {node.name}(): one instance is "
                    "shared across every call",
                )
            elif _is_config_call(d):
                self._emit(
                    "RPR102", d,
                    f"config instance as default in {node.name}(): built "
                    "once at import, shared by every caller (use a None "
                    "sentinel)",
                )
        # A nested def inherits hotness: closures inside a dispatch method
        # still run on its critical path.
        entered_hot = bool(self._hot_depth) or node.name in self.hot_functions
        self._depth += 1
        if entered_hot:
            self._hot_depth += 1
        self.generic_visit(node)
        if entered_hot:
            self._hot_depth -= 1
        self._depth -= 1

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_ClassDef(self, node) -> None:
        # Class bodies are not module scope for RPR102/RPR103 purposes
        # (class attributes are a separate hazard this repo does not use).
        self._depth += 1
        self.generic_visit(node)
        self._depth -= 1

    # -- statements ---------------------------------------------------------
    def visit_Assert(self, node: ast.Assert) -> None:
        self._emit(
            "RPR104", node,
            "bare assert is stripped under `python -O`; raise "
            "ValueError/RuntimeError for checks that must survive",
        )
        self.generic_visit(node)

    def visit_Global(self, node: ast.Global) -> None:
        if self.in_serving:
            self._emit(
                "RPR103", node,
                f"`global {', '.join(node.names)}` mutates module state "
                "shared across server instances (move it onto the owning "
                "object)",
            )
        self.generic_visit(node)

    def _module_assign(self, target: ast.AST, value: ast.AST) -> None:
        if not isinstance(target, ast.Name) or target.id.startswith("__"):
            return
        if self.in_serving and _is_mutable_literal(value):
            self._emit(
                "RPR103", value,
                f"module-level mutable {type(value).__name__.lower()} "
                f"`{target.id}` is shared across every server in the "
                "process",
            )
        if _is_config_call(value) and not self.in_configs:
            self._emit(
                "RPR102", value,
                f"module-level config instance `{target.id}` is built at "
                "import time and shared by every consumer",
            )

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._depth == 0:
            for t in node.targets:
                self._module_assign(t, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if self._depth == 0 and node.value is not None:
            self._module_assign(node.target, node.value)
        self.generic_visit(node)

    # -- calls --------------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        # RPR105: torch.from_numpy(<...>.page_table / .seq_lens) without .copy()
        if (
            self.in_serving
            and name in _NUMPY_WRAPPERS
            and isinstance(node.func, ast.Attribute)
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "torch"
            and node.args
        ):
            arg = node.args[0]
            if (
                isinstance(arg, ast.Attribute)
                and arg.attr in _MIRROR_ATTRS
                and not _ends_in_copy(arg)
            ):
                self._emit(
                    "RPR105", node,
                    f"torch.{name} over the live `{arg.attr}` mirror: the "
                    "tensor shares the array's memory, aliasing an array the "
                    "server mutates after dispatch — snapshot with .copy() "
                    "(or justify why no mutation can precede the read)",
                )
        # RPR106: host syncs inside registered hot paths.
        if self._hot_depth:
            if name in _SYNC_CALLS:
                self._emit(
                    "RPR106", node,
                    f"`{name}` blocks the host inside a hot path; sync "
                    "only at the stream boundary (harvest)",
                )
            elif (
                isinstance(node.func, ast.Name)
                and node.func.id in ("float", "int")
                and node.args
            ):
                self._emit(
                    "RPR106", node,
                    f"builtin {node.func.id}() on a tensor forces a "
                    "device sync inside a hot path",
                )
        self.generic_visit(node)


def _allow_pragmas(lines: list[str]) -> dict[int, tuple[str, str, int]]:
    """line number (1-based) -> (rule, reason, pragma line number)."""
    out: dict[int, tuple[str, str, int]] = {}
    for i, text in enumerate(lines, start=1):
        m = _ALLOW_RE.search(text)
        if m:
            out[i] = (m.group(1), m.group(2), i)
    return out


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one file's source; ``path`` selects path-scoped rules
    (``serving/`` for RPR103/RPR105, :data:`HOT_PATHS` for RPR106) and is
    reported in findings."""
    posix = Path(path).as_posix()
    hot = frozenset()
    for suffix, names in HOT_PATHS.items():
        if posix.endswith(suffix):
            hot = names
            break
    in_serving = "/serving/" in posix or posix.startswith("serving/")
    in_configs = "/configs/" in posix or posix.startswith("configs/")
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("RPR000", path, e.lineno or 0, e.offset or 0,
                        f"syntax error: {e.msg}")]
    visitor = _Visitor(path, hot, in_serving, in_configs)
    visitor.visit(tree)

    lines = source.splitlines()
    pragmas = _allow_pragmas(lines)
    kept: list[Finding] = []
    used: set[int] = set()
    for f in sorted(visitor.findings, key=lambda f: (f.line, f.col, f.rule)):
        suppressed = False
        for ln in (f.line, f.line - 1):
            pragma = pragmas.get(ln)
            if pragma and pragma[0] == f.rule:
                used.add(ln)
                if pragma[1]:
                    suppressed = True
                # An unjustified pragma is reported below and does not
                # suppress — the justification IS the point.
                break
        if not suppressed:
            kept.append(f)
    for ln, (rule, reason, _) in sorted(pragmas.items()):
        if not reason:
            kept.append(Finding(
                "RPR100", path, ln, 0,
                f"allow[{rule}] needs a written justification "
                "(`# repro: allow[RPRnnn] <why this is safe>`)",
            ))
    return sorted(kept, key=lambda f: (f.line, f.col, f.rule))


def iter_python_files(paths: Iterable[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(
                f for f in path.rglob("*.py") if "__pycache__" not in f.parts
            )
        elif path.suffix == ".py":
            yield path


def lint_paths(paths: Iterable[str]) -> list[Finding]:
    """Lint every ``.py`` under the given files/directories."""
    findings: list[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings
