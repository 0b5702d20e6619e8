"""Repo-invariant AST lint of the port (counterpart of
``repro.analysis.lint``).

A small ``ast`` pass over ``src/repro_torch``, ``chip_smoke.py`` and
``tools/`` (:data:`DEFAULT_SCAN`), with the JAX package's rules that
have a meaning here and one of the port's own:

``accepted-kwarg-not-forwarded``
    A ``def`` accepts a named parameter that its body never reads or
    passes on (the JAX package's PR 4 bug: ``precision=`` accepted by the
    MEC paths and dropped).  ``self``/``cls``/``_*`` and interface stubs
    (``pass``/``...``/``raise NotImplementedError`` bodies) are exempt.

``raw-environ-read-outside-compat``
    ``os.environ[...]``, ``os.environ.get``/``setdefault`` or
    ``os.getenv`` read anywhere but the port's owners of environment
    surface: the plan cache (``plan/cache.py``), the calibration store
    (``plan/calibrate.py``), the kernel build (``kernels/build.py``,
    which finds nvcc) and the process plumbing (``launch/mesh.py``, which
    reads the world ``torchrun`` describes).

``no-reference-import``
    ``import jax``, ``from jax ...``, ``import jaxlib``, ``import repro``
    or ``from repro... import``: the port imports nothing of JAX and
    nothing of the JAX package, which is its reference, not a library.

The JAX package's other rules have no meaning here: there is no
``shard_map`` (``shard-map-import-outside-compat``) and no
``REPRO_MEC_ACC_BYTES`` override (``deprecated-acc-bytes-env``; the
port's blocks come from the pickers or a plan).  Its
``no-bare-dot-precision`` asks a GEMM's call site for an accumulation
width; the port's counterpart reads the traced program instead, the
``accumulation`` rule of ``analysis.numcheck``, rather than a second
copy of it here.

Suppression: ``# lint-ignore: <rule>[, <rule>...]`` (or a bare
``# lint-ignore``) on the flagged line, for the kwarg rule on the
``def`` line.  Grandfathered findings live in
:data:`DEFAULT_BASELINE`, keyed ``rule:path:symbol``; it starts empty,
so every finding fails the run.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

LINT_BASELINE_VERSION = 1

RULES = (
    "accepted-kwarg-not-forwarded",
    "raw-environ-read-outside-compat",
    "no-reference-import",
)

#: files allowed to read the environment raw: their overrides are their
#: public configuration (cache and calibration paths, the CUDA toolkit,
#: the rank and world ``torchrun`` sets)
_ENVIRON_ALLOWED = ("plan/cache.py", "plan/calibrate.py", "kernels/build.py",
                    "launch/mesh.py")
#: top-level modules the port never imports
_REFERENCE_MODULES = ("jax", "jaxlib", "repro")

#: scanned relative to the repository root; tests are out of scope (they
#: import both packages, and fixtures plant violations)
DEFAULT_SCAN = ("src/repro_torch", "chip_smoke.py", "tools")
DEFAULT_BASELINE = "src/repro_torch/analysis/lint_baseline.json"

_SUPPRESS_RE = re.compile(r"#\s*lint-ignore(?::\s*(?P<rules>[\w\-, ]+))?")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint violation.  ``key()`` is the line-free identity the
    baseline stores: rule + file + symbol."""

    rule: str
    path: str                  # repo-relative, forward slashes
    symbol: str
    lineno: int
    message: str

    def key(self) -> str:
        return f"{self.rule}:{self.path}:{self.symbol}"

    def render(self) -> str:
        return f"{self.path}:{self.lineno}: [{self.rule}] {self.message}"


def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    m = _SUPPRESS_RE.search(lines[lineno - 1])
    if not m:
        return False
    rules = m.group("rules")
    return rules is None or rule in {r.strip() for r in rules.split(",")}


def _is_stub_body(body: Sequence[ast.stmt]) -> bool:
    """Interface stubs legitimately ignore their parameters."""
    stmts = list(body)
    if stmts and isinstance(stmts[0], ast.Expr) and \
            isinstance(stmts[0].value, ast.Constant) and \
            isinstance(stmts[0].value.value, str):
        stmts = stmts[1:]                      # docstring
    if not stmts:
        return True
    if len(stmts) > 1:
        return False
    s = stmts[0]
    if isinstance(s, ast.Pass):
        return True
    if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant) \
            and s.value.value is Ellipsis:
        return True
    if isinstance(s, ast.Raise) and s.exc is not None:
        name = s.exc.func if isinstance(s.exc, ast.Call) else s.exc
        return getattr(name, "id", None) == "NotImplementedError"
    return False


def _check_unused_params(tree: ast.AST, path: str,
                         lines: Sequence[str]) -> List[Finding]:
    rule = "accepted-kwarg-not-forwarded"
    out: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if any(isinstance(d, ast.Name) and d.id == "overload"
               for d in node.decorator_list):
            continue
        if _is_stub_body(node.body):
            continue
        args = node.args
        params = [a.arg for a in (args.posonlyargs + args.args
                                  + args.kwonlyargs)]
        names_read = {n.id for stmt in node.body
                      for n in ast.walk(stmt) if isinstance(n, ast.Name)}
        for p in params:
            if p in ("self", "cls") or p.startswith("_") or p in names_read:
                continue
            if _suppressed(lines, node.lineno, rule):
                continue
            out.append(Finding(
                rule=rule, path=path, symbol=f"{node.name}:{p}",
                lineno=node.lineno,
                message=f"def {node.name}(...) accepts {p!r} but its body "
                        f"never reads or forwards it (the dropped-kwarg "
                        f"class)"))
    return out


def _environ_reads(tree: ast.AST) -> Iterable[Tuple[ast.AST, str,
                                                    Optional[ast.expr]]]:
    """(node, kind, key expression) of every raw environment read:
    ``os.environ.get/setdefault(k)``, ``os.environ[k]`` loads and
    ``os.getenv(k)``.  Writes are not reads."""
    def is_os_environ(n: ast.AST) -> bool:
        return (isinstance(n, ast.Attribute) and n.attr == "environ"
                and isinstance(n.value, ast.Name) and n.value.id == "os")

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Attribute) and \
                    f.attr in ("get", "setdefault") and is_os_environ(f.value):
                yield node, f"os.environ.{f.attr}", \
                    node.args[0] if node.args else None
            elif isinstance(f, ast.Attribute) and f.attr == "getenv" and \
                    isinstance(f.value, ast.Name) and f.value.id == "os":
                yield node, "os.getenv", node.args[0] if node.args else None
        elif isinstance(node, ast.Subscript) and \
                is_os_environ(node.value) and isinstance(node.ctx, ast.Load):
            yield node, "os.environ[...]", node.slice


def _check_environ_reads(tree: ast.AST, path: str,
                         lines: Sequence[str]) -> List[Finding]:
    rule = "raw-environ-read-outside-compat"
    if any(path.endswith(a) for a in _ENVIRON_ALLOWED):
        return []
    out: List[Finding] = []
    for node, kind, key in _environ_reads(tree):
        key_name = None
        if isinstance(key, ast.Constant) and isinstance(key.value, str):
            key_name = key.value
        elif isinstance(key, ast.Name):
            key_name = key.id
        if _suppressed(lines, node.lineno, rule):
            continue
        out.append(Finding(
            rule=rule, path=path, symbol=f"{kind}:{key_name or '<dynamic>'}",
            lineno=node.lineno,
            message=f"{kind}({key_name or '...'}) outside "
                    f"{_ENVIRON_ALLOWED}: environment surface belongs to "
                    f"the plan cache, the calibration store or the build"))
    return out


def _reference_module(name: str) -> Optional[str]:
    top = name.split(".")[0]
    return top if top in _REFERENCE_MODULES else None


def _check_reference_imports(tree: ast.AST, path: str,
                             lines: Sequence[str]) -> List[Finding]:
    rule = "no-reference-import"
    out: List[Finding] = []
    for node in ast.walk(tree):
        mods = []
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        for mod in mods:
            top = _reference_module(mod)
            if top is None or _suppressed(lines, node.lineno, rule):
                continue
            out.append(Finding(
                rule=rule, path=path, symbol=f"import:{mod}",
                lineno=node.lineno,
                message=f"imports {mod}: the port imports nothing of "
                        f"{'JAX' if top != 'repro' else 'the JAX package'}"))
    return out


def lint_file(path: pathlib.Path, rel: str) -> List[Finding]:
    source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [Finding(rule="accepted-kwarg-not-forwarded", path=rel,
                        symbol="<syntax-error>", lineno=e.lineno or 0,
                        message=f"file does not parse: {e.msg}")]
    lines = source.splitlines()
    return (_check_unused_params(tree, rel, lines)
            + _check_environ_reads(tree, rel, lines)
            + _check_reference_imports(tree, rel, lines))


def repo_root() -> pathlib.Path:
    """The checkout root (three levels above this file's package)."""
    return pathlib.Path(__file__).resolve().parents[3]


def lint_tree(root: Optional[pathlib.Path] = None,
              scan: Sequence[str] = DEFAULT_SCAN) -> List[Finding]:
    root = pathlib.Path(root) if root is not None else repo_root()
    findings: List[Finding] = []
    for entry in scan:
        base = root / entry
        files = [base] if base.is_file() else sorted(base.rglob("*.py")) \
            if base.exists() else []
        for py in files:
            findings.extend(lint_file(py, py.relative_to(root).as_posix()))
    return sorted(findings, key=lambda f: (f.path, f.lineno, f.rule))


# ---------------------------------------------------------------- baseline

def load_baseline(path) -> List[str]:
    doc = json.loads(pathlib.Path(path).read_text())
    if doc.get("lint_baseline_version") != LINT_BASELINE_VERSION:
        raise ValueError(
            f"lint baseline {path} has version "
            f"{doc.get('lint_baseline_version')!r}, expected "
            f"{LINT_BASELINE_VERSION}")
    keys = doc.get("findings")
    if not isinstance(keys, list) or \
            not all(isinstance(k, str) for k in keys):
        raise ValueError(f"lint baseline {path}: findings must be a list "
                         "of rule:path:symbol strings")
    return keys


def write_baseline(findings: Sequence[Finding], path) -> None:
    doc = {"lint_baseline_version": LINT_BASELINE_VERSION,
           "findings": sorted({f.key() for f in findings})}
    pathlib.Path(path).write_text(
        json.dumps(doc, indent=2, sort_keys=True) + "\n")


def apply_baseline(findings: Sequence[Finding],
                   baseline_keys: Sequence[str]) -> Dict[str, List]:
    """Split findings into new failures and grandfathered ones, and name
    the baseline entries that no longer fire (shrink the file)."""
    baseline = set(baseline_keys)
    new = [f for f in findings if f.key() not in baseline]
    grandfathered = [f for f in findings if f.key() in baseline]
    fixed = sorted(baseline - {f.key() for f in findings})
    return {"new": new, "grandfathered": grandfathered, "fixed": fixed}
