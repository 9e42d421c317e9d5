"""The port's AST lint: its layering rules, held statically (counterpart of
``repro.analysis.lint``). Suppress a line with
``# repro_torch: allow(<rule>)``. Paths are read relative to the package:
``kernels/``, ``core/``, ``serving/``, ``obs/``, ``analysis/``.

  * ``kernel-launch-site`` — ``_build.load`` and ctypes library loads
    (``ctypes.CDLL``, ``ctypes.cdll``) appear only under ``kernels/``:
    engines and serving reach a kernel through the wrappers, which check
    shapes and launch.
  * ``padding-outside-ops`` — no ``F.pad`` / ``torch.nn.functional.pad`` in
    ``core/`` or ``serving/``: the sentinel convention lives in
    ``kernels/ops.py`` (``pad_lane_batch``).
  * ``unregistered-kernel-module`` — a ``kernels/`` module that calls
    ``_build.load`` defines ``register_kernels``, or its kernels dodge the
    contract audit.
  * ``env-outside-config`` — ``REPRO_*`` variables are read only in
    ``kernels/config.py``.
  * ``raw-timer`` — no ``perf_counter`` or ``time.time`` outside ``obs/``:
    timing goes through ``repro_torch.obs.timer`` (or CUDA events in
    ``config.measure_launch``).
  * ``swallowed-exception`` — no bare ``except:``, and no ``except
    Exception/BaseException:`` whose whole body is ``pass`` / ``...``.
  * ``hardcoded-twin`` — no literal ``use_kernels=False`` outside
    ``kernels/ref.py``, ``kernels/registry.py`` and ``analysis/``: a twin
    runs because its tensors lie on the CPU or because a caller asked for
    it, never because library code fixed it (the counterpart of
    ``hardcoded-interpret``).
  * ``reference-import`` — no ``import jax`` and no import of the
    reference package ``repro``: the port keeps its own copy of what it
    needs.

The reference's ``donate-reuse`` has no counterpart: PyTorch never aliases
an argument's buffer into a result behind the caller's back (the port's
``donate`` flags are accepted and ignored), so a read after a call cannot
see a donated buffer.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

RULES = (
    "kernel-launch-site",
    "padding-outside-ops",
    "unregistered-kernel-module",
    "env-outside-config",
    "raw-timer",
    "swallowed-exception",
    "hardcoded-twin",
    "reference-import",
)

_PRAGMA_RE = re.compile(r"#\s*repro_torch:\s*allow\(([a-z0-9_,\s\-]+)\)")
_TWIN_FILES = (("kernels", "ref.py"), ("kernels", "registry.py"))


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


def _call_target(node: ast.Call) -> str:
    """Dotted name of a call target: 'ctypes.CDLL', 'os.environ.get', ..."""
    parts: list[str] = []
    f = node.func
    while isinstance(f, ast.Attribute):
        parts.append(f.attr)
        f = f.value
    if isinstance(f, ast.Name):
        parts.append(f.id)
    return ".".join(reversed(parts))


def _is_env_read(node: ast.AST) -> bool:
    """os.environ[...] (a load) / os.environ.get(...) / os.getenv(...)."""
    if isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Load):
        v = node.value
        return isinstance(v, ast.Attribute) and v.attr == "environ"
    if isinstance(node, ast.Call):
        tgt = _call_target(node)
        return tgt.endswith("getenv") or tgt.endswith("environ.get")
    return False


def _env_key(node: ast.AST) -> str | None:
    if isinstance(node, ast.Subscript):
        s = node.slice
        if isinstance(s, ast.Constant) and isinstance(s.value, str):
            return s.value
    if isinstance(node, ast.Call) and node.args:
        a = node.args[0]
        if isinstance(a, ast.Constant) and isinstance(a.value, str):
            return a.value
    return None


def _is_reference(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


class _Zone:
    """Which rules apply where, from the path's parts."""

    def __init__(self, path: str):
        p = pathlib.PurePosixPath(path.replace("\\", "/"))
        parts = p.parts
        if "repro_torch" in parts:  # the parts inside the package
            parts = parts[len(parts) - parts[::-1].index("repro_torch"):]
        self.in_kernels = "kernels" in parts
        self.is_config = self.in_kernels and p.name == "config.py"
        self.in_engine = ("core" in parts) or ("serving" in parts)
        self.in_obs = "obs" in parts
        self.twin_ok = "analysis" in parts or any(
            d in parts and p.name == f for d, f in _TWIN_FILES)


def _is_false(node) -> bool:
    return isinstance(node, ast.Constant) and node.value is False


def lint_source(src: str, path: str) -> list[LintFinding]:
    """Lint one file's source text; ``path`` decides which rules apply."""
    zone = _Zone(path)
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [LintFinding(path, e.lineno or 0, "kernel-launch-site",
                            f"file does not parse: {e.msg}")]
    findings: list[LintFinding] = []

    def emit(lineno: int, rule: str, message: str) -> None:
        text = lines[lineno - 1] if 0 < lineno <= len(lines) else ""
        m = _PRAGMA_RE.search(text)
        if m is None or rule not in {s.strip() for s in m.group(1).split(",")}:
            findings.append(LintFinding(path, lineno, rule, message))

    saw_load = False
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            tgt = _call_target(node)
            if tgt.endswith("_build.load") or tgt.startswith("ctypes.CDLL") \
                    or tgt.startswith("ctypes.cdll") or tgt == "CDLL":
                saw_load |= tgt.endswith("_build.load")
                if not zone.in_kernels:
                    emit(node.lineno, "kernel-launch-site",
                         f"{tgt} outside repro_torch/kernels: go through the "
                         "kernel wrappers")
            if zone.in_engine and (tgt in ("F.pad", "functional.pad")
                                   or tgt.endswith("nn.functional.pad")):
                emit(node.lineno, "padding-outside-ops",
                     f"{tgt} in engine or serving code: padding is the "
                     "kernels layer's job (ops.pad_lane_batch)")
            if (tgt.endswith("perf_counter") or tgt == "time.time") \
                    and not zone.in_obs:
                emit(node.lineno, "raw-timer",
                     f"{tgt} outside repro_torch/obs: use repro_torch.obs."
                     "timer (or CUDA events) so timing shares one clock")
            for kw in node.keywords:
                if kw.arg == "use_kernels" and _is_false(kw.value) \
                        and not zone.twin_ok:
                    emit(kw.value.lineno, "hardcoded-twin",
                         "use_kernels=False hardcoded: leave the choice "
                         "to the caller")
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and not zone.twin_ok:
            args = node.args
            pos = args.posonlyargs + args.args
            pairs = list(zip(pos[len(pos) - len(args.defaults):],
                             args.defaults))
            pairs += [(a, d) for a, d in zip(args.kwonlyargs,
                                             args.kw_defaults) if d]
            for a, d in pairs:
                if a.arg == "use_kernels" and _is_false(d):
                    emit(d.lineno, "hardcoded-twin",
                         "use_kernels=False as a default: the kernels are "
                         "the default, the twins the caller's choice")
        if _is_env_read(node):
            key = _env_key(node)
            if key and key.startswith("REPRO_") and not zone.is_config:
                emit(node.lineno, "env-outside-config",
                     f"{key} read outside kernels/config.py: every "
                     "REPRO_* variable resolves there")
        if isinstance(node, ast.Import):
            for alias in node.names:
                if _is_reference(alias.name):
                    emit(node.lineno, "reference-import",
                         f"import {alias.name}: the port imports neither "
                         "jax nor the reference package")
        if isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and _is_reference(node.module):
            emit(node.lineno, "reference-import",
                 f"from {node.module} import ...: the port imports neither "
                 "jax nor the reference package")
        if isinstance(node, ast.ExceptHandler):
            broad = (isinstance(node.type, ast.Name)
                     and node.type.id in ("Exception", "BaseException"))
            noop = all(isinstance(s, ast.Pass)
                       or (isinstance(s, ast.Expr)
                           and isinstance(s.value, ast.Constant)
                           and s.value.value is Ellipsis)
                       for s in node.body)
            if node.type is None:
                emit(node.lineno, "swallowed-exception",
                     "bare except: catches everything, KeyboardInterrupt "
                     "too; name the exception type")
            elif broad and noop:
                emit(node.lineno, "swallowed-exception",
                     f"except {node.type.id}: pass swallows every error; "
                     "handle it, count it, or narrow the type")
    if saw_load and zone.in_kernels and not any(
            isinstance(n, ast.FunctionDef) and n.name == "register_kernels"
            for n in tree.body):
        emit(1, "unregistered-kernel-module",
             "module loads a kernel library but defines no register_kernels "
             "hook: its kernels dodge the contract audit")
    return findings


def lint_paths(paths) -> list[LintFinding]:
    """Lint files and directory trees (``*.py``, sorted, recursive)."""
    files: list[pathlib.Path] = []
    for p in paths:
        p = pathlib.Path(p)
        files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings: list[LintFinding] = []
    for f in files:
        findings.extend(lint_source(f.read_text(), str(f)))
    return findings
