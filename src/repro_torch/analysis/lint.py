"""Repo-specific AST lint pass over ``src/repro_torch``.

Generic linters don't know this codebase's failure modes; these rules each
pin a bug class that has actually bitten (or nearly bitten) the engine:

========  ==================================================================
rule      what it flags
========  ==================================================================
GDL001    new module-global mutable state (dict/list/set displays or
          constructor calls bound at module scope). The ``WRITE_COUNTERS``
          bug class: shared mutable globals silently couple engines and
          break per-graph isolation. Exemption: ``__all__``.
GDL002    host-device sync points outside the fenced telemetry span: any
          call named ``synchronize`` (``torch.cuda.synchronize``,
          ``Event.synchronize``, ``Stream.synchronize``) outside
          ``repro_torch/core/telemetry.py`` (which owns the fence), and,
          inside the ``run()`` hot path of a GCDA operator (whose inputs
          are device tensors), ``np.asarray``/``np.array`` and the tensor
          methods ``.cpu()``, ``.numpy()``, ``.item()`` and ``.tolist()``
          — each a silent device-to-host copy and sync per call.
GDL003    lock acquisition while already holding a lock in the same
          function (a ``with <lock>`` or ``.acquire()`` nested inside
          another ``with <lock>`` body). The InterBuffer/Registry deadlock
          class: nested acquisition orders deadlock under morsel-parallel
          execution.
GDL004    bare ``except:`` — swallows ``KeyboardInterrupt``/``SystemExit``
          and masks real planner bugs as silent fallbacks.
GDL005    mutable default arguments (``def f(x=[])``) — call-to-call state
          leakage.
========  ==================================================================

Findings print as ``path:line: RULE message``. A baseline file
(``src/repro_torch/analysis/lint_baseline.json``) records accepted
pre-existing findings keyed by ``(rule, path, enclosing scope, source
line)`` — stable across unrelated line drift — and the gate fails only on
findings *not* in the baseline.

CLI (from the repository root)::

    python -m repro_torch.analysis.lint [paths...] \
        [--baseline src/repro_torch/analysis/lint_baseline.json] \
        [--write-baseline]

Exit status 1 when new (non-baselined) findings exist.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

MUTABLE_CONSTRUCTORS = frozenset({"dict", "list", "set", "defaultdict",
                                  "OrderedDict", "Counter", "deque",
                                  "bytearray"})
MUTABLE_DISPLAYS = (ast.Dict, ast.List, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
GDL001_EXEMPT_NAMES = frozenset({"__all__"})

# kind strings of physical operators whose run() consumes device tensors —
# np.asarray or a tensor's .cpu()/.numpy()/.item()/.tolist() there is a
# hidden device->host copy + sync
GCDA_OP_KINDS = frozenset({"Rel2Matrix", "RandomAccessMatrix", "Const",
                           "MatMul", "Similarity", "Regression"})

# telemetry owns the one sanctioned synchronize (the span fence)
GDL002_EXEMPT_FILES = frozenset({"repro_torch/core/telemetry.py"})
# tensor methods that copy a device value to the host (and wait for it)
HOST_COPY_METHODS = frozenset({"cpu", "numpy", "item", "tolist"})

DEFAULT_PATH = Path("src/repro_torch")
DEFAULT_BASELINE = Path("src/repro_torch/analysis/lint_baseline.json")

LOCK_NAME_HINTS = ("lock",)     # attribute/variable names treated as locks


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str       # repo-relative, forward slashes
    line: int
    scope: str      # dotted enclosing scope ("<module>", "Class.method")
    snippet: str    # stripped source line (baseline key component)
    message: str

    def key(self) -> tuple:
        return (self.rule, self.path, self.scope, self.snippet)

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _call_name(node: ast.AST) -> Optional[str]:
    """Trailing name of a call target: ``foo()`` -> foo, ``a.b.foo()`` -> foo."""
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Name):
            return f.id
        if isinstance(f, ast.Attribute):
            return f.attr
    return None


def _is_lock_expr(node: ast.AST) -> bool:
    """Does this with-context / call target look like a lock? Matches bare
    names and attributes whose final component contains 'lock'
    (``self._lock``, ``self._pool_lock``, ``registry.lock``)."""
    name = None
    if isinstance(node, ast.Name):
        name = node.id
    elif isinstance(node, ast.Attribute):
        name = node.attr
    return name is not None and any(h in name.lower()
                                    for h in LOCK_NAME_HINTS)


def _is_mutable_value(node: ast.AST) -> bool:
    if isinstance(node, MUTABLE_DISPLAYS):
        return True
    cn = _call_name(node)
    return cn in MUTABLE_CONSTRUCTORS


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: list[Finding] = []
        self.scope: list[str] = []        # class/function name stack
        self.func_depth = 0
        self.class_depth = 0
        self.lock_depth = 0               # with-lock nesting in this function
        self.gcda_run_depth = 0           # inside a GCDA operator's run()
        self.class_kinds: list[Optional[str]] = []   # kind= of class stack

    # -- plumbing --

    def _scope_name(self) -> str:
        return ".".join(self.scope) if self.scope else "<module>"

    def _snippet(self, node: ast.AST) -> str:
        i = getattr(node, "lineno", 1) - 1
        return self.lines[i].strip() if 0 <= i < len(self.lines) else ""

    def add(self, rule: str, node: ast.AST, message: str):
        self.findings.append(Finding(rule, self.path,
                                     getattr(node, "lineno", 1),
                                     self._scope_name(),
                                     self._snippet(node), message))

    # -- scope tracking --

    def visit_ClassDef(self, node: ast.ClassDef):
        kind = None
        for stmt in node.body:
            if (isinstance(stmt, ast.Assign)
                    and any(isinstance(t, ast.Name) and t.id == "kind"
                            for t in stmt.targets)
                    and isinstance(stmt.value, ast.Constant)):
                kind = stmt.value.value
        self.scope.append(node.name)
        self.class_depth += 1
        self.class_kinds.append(kind)
        self.generic_visit(node)
        self.class_kinds.pop()
        self.class_depth -= 1
        self.scope.pop()

    def _visit_func(self, node):
        for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None]:
            if _is_mutable_value(default):
                self.add("GDL005", default,
                         f"mutable default argument in {node.name}() — "
                         f"shared across calls; default to None instead")
        in_gcda_run = (node.name == "run" and self.class_kinds
                       and self.class_kinds[-1] in GCDA_OP_KINDS)
        self.scope.append(node.name)
        self.func_depth += 1
        outer_locks = self.lock_depth
        self.lock_depth = 0               # lock nesting is per-function
        if in_gcda_run:
            self.gcda_run_depth += 1
        self.generic_visit(node)
        if in_gcda_run:
            self.gcda_run_depth -= 1
        self.lock_depth = outer_locks
        self.func_depth -= 1
        self.scope.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # -- GDL001: module-global mutable state --

    def _check_global_assign(self, node, targets, value):
        if self.func_depth or self.class_depth or value is None:
            return
        names = [t.id for t in targets if isinstance(t, ast.Name)]
        if names and all(n in GDL001_EXEMPT_NAMES for n in names):
            return
        if _is_mutable_value(value):
            what = ", ".join(names) or "<target>"
            self.add("GDL001", node,
                     f"module-global mutable state ({what}) — the "
                     f"WRITE_COUNTERS bug class; scope it to an instance "
                     f"or make it immutable")

    def visit_Assign(self, node: ast.Assign):
        self._check_global_assign(node, node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        self._check_global_assign(node, [node.target], node.value)
        self.generic_visit(node)

    # -- GDL002: host syncs outside the telemetry fence --

    def visit_Call(self, node: ast.Call):
        cn = _call_name(node)
        if cn == "synchronize" and self.path not in GDL002_EXEMPT_FILES:
            self.add("GDL002", node,
                     "synchronize outside repro_torch/core/telemetry.py — "
                     "host-device sync belongs behind the fenced telemetry "
                     "span (telemetry.fence)")
        elif (cn in ("asarray", "array") and self.gcda_run_depth
              and isinstance(node.func, ast.Attribute)
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "np"):
            self.add("GDL002", node,
                     "np.asarray/np.array inside a GCDA operator's run() — "
                     "silently copies the device tensor to the host and "
                     "syncs; keep the hot path device-resident")
        elif (cn in HOST_COPY_METHODS and self.gcda_run_depth
              and isinstance(node.func, ast.Attribute)):
            self.add("GDL002", node,
                     f".{cn}() inside a GCDA operator's run() — silently "
                     f"copies the device tensor to the host and syncs; "
                     f"keep the hot path device-resident")
        if cn == "acquire" and self.lock_depth and \
                isinstance(node.func, ast.Attribute) and \
                _is_lock_expr(node.func):
            self.add("GDL003", node,
                     "lock.acquire() while already holding a lock — the "
                     "nested-acquisition deadlock class")
        self.generic_visit(node)

    # -- GDL003: nested lock acquisition --

    def visit_With(self, node: ast.With):
        lockish = sum(1 for item in node.items
                      if _is_lock_expr(item.context_expr))
        if lockish and self.lock_depth:
            self.add("GDL003", node,
                     "nested `with <lock>` while already holding a lock in "
                     "this function — acquisition orders deadlock under "
                     "morsel-parallel execution")
        self.lock_depth += lockish
        self.generic_visit(node)
        self.lock_depth -= lockish

    # -- GDL004: bare except --

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        if node.type is None:
            self.add("GDL004", node,
                     "bare `except:` — catches KeyboardInterrupt/SystemExit "
                     "and masks planner bugs; name the exception")
        self.generic_visit(node)


def lint_file(path: Path, root: Path) -> list[Finding]:
    resolved = path.resolve()
    try:
        rel = resolved.relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = path.as_posix()
    # baseline keys (and the GDL002 exemption) are src-relative
    if rel.startswith("src/"):
        rel = rel[len("src/"):]
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError) as exc:
        return [Finding("GDL000", rel, getattr(exc, "lineno", 1) or 1,
                        "<module>", "", f"unparseable: {exc}")]
    linter = _Linter(rel, source)
    linter.visit(tree)
    return linter.findings


def lint_paths(paths: list[Path], root: Path) -> list[Finding]:
    findings: list[Finding] = []
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f, root))
    return findings


# ---------------------------------------------------------------------------
# baseline handling
# ---------------------------------------------------------------------------


def load_baseline(path: Path) -> list:
    if not path.exists():
        return []
    return [tuple(k) for k in json.loads(path.read_text())]


def save_baseline(path: Path, findings: list[Finding]) -> None:
    keys = sorted(f.key() for f in findings)
    path.write_text(json.dumps(keys, indent=2) + "\n")


def split_by_baseline(findings: list[Finding], baseline: list
                      ) -> tuple[list[Finding], list[Finding]]:
    """Partition into (new, baselined). Baseline keys are a multiset: two
    identical findings need two baseline entries."""
    pool: dict[tuple, int] = {}
    for k in baseline:
        pool[k] = pool.get(k, 0) + 1
    new, old = [], []
    for f in findings:
        k = f.key()
        if pool.get(k, 0) > 0:
            pool[k] -= 1
            old.append(f)
        else:
            new.append(f)
    return new, old


def main(argv: Optional[list] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    write = "--write-baseline" in args
    if write:
        args.remove("--write-baseline")
    baseline_path = DEFAULT_BASELINE
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline_path = Path(args[i + 1])
        del args[i:i + 2]
    root = Path.cwd()
    paths = [Path(a) for a in args] or [DEFAULT_PATH]

    findings = lint_paths(paths, root)
    if write:
        save_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} finding(s) to {baseline_path}")
        return 0
    new, old = split_by_baseline(findings, load_baseline(baseline_path))
    for f in new:
        print(f.render())
    counts: dict[str, int] = {}
    for f in findings:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    summary = " ".join(f"{r}={n}" for r, n in sorted(counts.items())) or "none"
    print(f"lint: {len(new)} new, {len(old)} baselined ({summary})")
    return 1 if new else 0


if __name__ == "__main__":
    raise SystemExit(main())
