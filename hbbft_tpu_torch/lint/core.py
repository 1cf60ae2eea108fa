"""hblint core: the checker framework (no dependencies beyond stdlib).

The pieces every checker shares:

- :class:`Finding` — one diagnostic, anchored to a file+line, carrying a
  content-based ``fingerprint`` so baselines survive line drift;
- :class:`ModuleSource` — one parsed source file (text, AST, suppression
  table).  Suppression comments::

      # hblint: disable=<rule>[,<rule>...]        (this line only)
      # hblint: disable-file=<rule>[,<rule>...]   (whole file)

  ``all`` suppresses every rule.  Anything after the rule list is a
  free-form justification (and writing one is the convention);
- :class:`Checker` — subclass, set ``name``/``rules``/``scope``, implement
  :meth:`Checker.check_module` (per in-scope file) and/or
  :meth:`Checker.check_project` (once per run, for cross-file rules);
- :func:`run_lint` — walk the scan set, run every registered checker,
  filter findings through suppressions and the checked-in baseline.

The baseline file (``hbbft_tpu_torch/lint/baseline.txt``) grandfathers known,
deliberate findings: one per line, ``<fingerprint> <rule> <path>  #
justification``.  Fingerprints hash the rule + path + anchored source
line (not the line *number*), so unrelated edits to the file do not
invalidate entries; editing the anchored line itself does, on purpose.
"""

from __future__ import annotations

import ast
import hashlib
import os
import re
import subprocess
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

# ---------------------------------------------------------------------------
# findings


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``rule`` fired in ``path`` at ``line``.

    ``snippet`` is the stripped source line the finding anchors to (empty
    for file-level findings); it feeds the fingerprint so baseline entries
    track content, not line numbers.
    """

    checker: str
    rule: str
    path: str  # repo-relative, posix separators
    line: int  # 1-based; 0 = whole file
    message: str
    snippet: str = ""

    @property
    def fingerprint(self) -> str:
        anchor = self.snippet.strip() or self.message
        raw = f"{self.rule}|{self.path}|{anchor}".encode()
        return hashlib.sha1(raw).hexdigest()[:12]

    def location(self) -> str:
        return f"{self.path}:{self.line}" if self.line else self.path

    def as_dict(self) -> dict:
        return {
            "checker": self.checker,
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }


# ---------------------------------------------------------------------------
# source model

# the rule list is comma-separated identifiers ONLY: it must stop at the
# first bare word so an unparenthesized justification ("... disable=x all
# timers are diagnostic") cannot leak tokens (like "all") into the list
_SUPPRESS_RE = re.compile(
    r"#\s*hblint:\s*(disable(?:-file)?)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


def _parse_rule_list(raw: str) -> Set[str]:
    return {tok.strip() for tok in raw.split(",") if tok.strip()}


class ModuleSource:
    """One scanned file: text, lazily-parsed AST, suppression table."""

    def __init__(self, root: str, rel_path: str):
        self.root = root
        self.path = rel_path.replace(os.sep, "/")
        self.abs_path = os.path.join(root, rel_path)
        with open(self.abs_path, encoding="utf-8") as fh:
            self.text = fh.read()
        self.lines = self.text.splitlines()
        self._tree: Optional[ast.AST] = None
        self._parse_error: Optional[SyntaxError] = None
        self._line_suppress: Dict[int, Set[str]] = {}
        self._file_suppress: Set[str] = set()
        self._scan_suppressions()

    # -- AST ---------------------------------------------------------------

    @property
    def tree(self) -> Optional[ast.AST]:
        """Parsed AST, or None on a syntax error (see ``parse_error``)."""
        if self._tree is None and self._parse_error is None:
            try:
                self._tree = ast.parse(self.text, filename=self.path)
            except SyntaxError as exc:
                self._parse_error = exc
        return self._tree

    @property
    def parse_error(self) -> Optional[SyntaxError]:
        self.tree
        return self._parse_error

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    # -- suppressions ------------------------------------------------------

    def _scan_suppressions(self) -> None:
        for i, line in enumerate(self.lines, start=1):
            if "hblint" not in line:
                continue
            for m in _SUPPRESS_RE.finditer(line):
                rules = _parse_rule_list(m.group(2))
                if m.group(1) == "disable-file":
                    self._file_suppress |= rules
                    continue
                self._line_suppress.setdefault(i, set()).update(rules)
                # a comment-only suppression line also covers the next
                # code line (so the comment can sit ABOVE a long
                # statement instead of trailing past the line width)
                if line.lstrip().startswith("#"):
                    j = i + 1
                    while j <= len(self.lines) and (
                        not self.lines[j - 1].strip()
                        or self.lines[j - 1].lstrip().startswith("#")
                    ):
                        j += 1
                    if j <= len(self.lines):
                        self._line_suppress.setdefault(
                            j, set()).update(rules)

    def is_suppressed(self, rule: str, line: int) -> bool:
        if "all" in self._file_suppress or rule in self._file_suppress:
            return True
        at = self._line_suppress.get(line, ())
        return "all" in at or rule in at


class Project:
    """The whole scan set, handed to project-level checkers."""

    def __init__(self, root: str, modules: Sequence[ModuleSource]):
        self.root = root
        self.modules = list(modules)
        self._by_path = {m.path: m for m in self.modules}

    def module(self, rel_path: str) -> Optional[ModuleSource]:
        return self._by_path.get(rel_path.replace(os.sep, "/"))

    def in_scope(self, prefixes: Sequence[str]) -> List[ModuleSource]:
        if not prefixes:
            return list(self.modules)
        return [
            m for m in self.modules
            if any(m.path.startswith(p) for p in prefixes)
        ]


# ---------------------------------------------------------------------------
# checkers


class Checker:
    """Base class.  Subclasses set:

    - ``name`` — checker id (used in reports and ``--checkers``);
    - ``rules`` — {rule-id: one-line description} (drives ``--list-rules``
      and the README table);
    - ``scope`` — path prefixes (relative to the repo root) the per-file
      pass applies to; ``()`` means every scanned file.
    """

    name: str = "base"
    rules: Dict[str, str] = {}
    scope: Tuple[str, ...] = ()

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        return ()

    def check_project(self, project: Project) -> Iterable[Finding]:
        return ()

    # helper: a Finding anchored to an AST node of ``mod``
    def finding(self, mod: ModuleSource, rule: str, node,
                message: str) -> Finding:
        line = getattr(node, "lineno", 0) if node is not None else 0
        return Finding(
            checker=self.name, rule=rule, path=mod.path, line=line,
            message=message, snippet=mod.line_at(line),
        )


_REGISTRY: List[Callable[[], Checker]] = []


def register(cls):
    """Class decorator: add a checker to the default suite."""
    _REGISTRY.append(cls)
    return cls


def all_checkers() -> List[Checker]:
    """Instantiate the full default suite (imports the checker modules)."""
    # imported for the registration side effect
    from hbbft_tpu_torch.lint import (  # noqa: F401
        asyncio_hazard,
        bounded_ingress,
        determinism,
        fault_accounting,
        metric_convention,
        wire_completeness,
    )

    return [cls() for cls in _REGISTRY]


def rule_table() -> Dict[str, Tuple[str, str]]:
    """{rule-id: (checker name, description)} for the default suite."""
    out = {}
    for chk in all_checkers():
        for rule, desc in chk.rules.items():
            out[rule] = (chk.name, desc)
    return out


# ---------------------------------------------------------------------------
# scan set

#: default scan targets, relative to the repo root — the package plus the
#: repo-level script; tests/ is deliberately excluded (lint fixtures live
#: there and contain intentional violations)
DEFAULT_PATHS = (
    "hbbft_tpu_torch",
    "chip_smoke.py",
)

# ``build`` holds the kernels compiled at first use (hbbft_tpu_torch/_build.py)
_SKIP_DIRS = {"__pycache__", ".git", ".jax_cache", "build"}


def default_root() -> str:
    """The repo root: the directory containing ``hbbft_tpu_torch``."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.dirname(pkg)


def collect_files(root: str, paths: Sequence[str]) -> List[str]:
    """Expand the scan set into sorted repo-relative ``.py`` paths."""
    out: Set[str] = set()
    for p in paths:
        absp = os.path.join(root, p)
        if os.path.isfile(absp):
            if absp.endswith(".py"):
                out.add(os.path.relpath(absp, root))
        elif os.path.isdir(absp):
            for dirpath, dirnames, filenames in os.walk(absp):
                dirnames[:] = [d for d in dirnames if d not in _SKIP_DIRS]
                for fn in filenames:
                    if fn.endswith(".py"):
                        out.add(os.path.relpath(
                            os.path.join(dirpath, fn), root))
    return sorted(o.replace(os.sep, "/") for o in out)


def changed_files(root: str, gitref: str) -> Set[str]:
    """Repo-relative paths changed vs ``gitref``: working-tree diff PLUS
    untracked files — a brand-new module must not dodge the pre-commit
    path just because it was never ``git add``\\ ed."""
    out: Set[str] = set()
    for cmd in (
        ["git", "diff", "--name-only", gitref, "--"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                cmd, cwd=root, capture_output=True, text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired) as exc:
            raise RuntimeError(f"{' '.join(cmd)} failed: {exc}")
        if proc.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed: {proc.stderr.strip()}"
            )
        out |= {l.strip() for l in proc.stdout.splitlines() if l.strip()}
    return out


# ---------------------------------------------------------------------------
# baseline

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.txt")


def load_baseline(path: str) -> Dict[str, str]:
    """{fingerprint: rest-of-line} from a baseline file (missing → {})."""
    out: Dict[str, str] = {}
    if not path or not os.path.exists(path):
        return out
    with open(path, encoding="utf-8") as fh:
        for raw in fh:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            fp = line.split()[0]
            out[fp] = line
    return out


def render_baseline(findings: Sequence[Finding]) -> str:
    """Serialize findings as a baseline file body (stable order).

    Fingerprints are content-based (rule + path + anchored source line),
    so one entry covers every identical-content occurrence in that file —
    deliberate: grandfathering `async with self._wlock:` once means the
    established pattern, not one blessed line number.
    """
    lines = [
        "# hblint baseline — grandfathered findings; one per line:",
        "#   <fingerprint> <rule> <path>  # justification",
        "# Regenerate with: python -m hbbft_tpu_torch.lint --write-baseline",
        "# (and then EDIT the justifications — they are the point).",
        "# An entry covers all identical-content occurrences in its file.",
    ]
    seen: Set[str] = set()
    for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line)):
        if f.fingerprint in seen:
            continue
        seen.add(f.fingerprint)
        lines.append(
            f"{f.fingerprint} {f.rule} {f.path}  # TODO justify: "
            f"{f.message[:100]}"
        )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# runner


@dataclass
class LintResult:
    findings: List[Finding] = field(default_factory=list)  # actionable
    baselined: List[Finding] = field(default_factory=list)
    suppressed: int = 0
    files_scanned: int = 0
    stale_baseline: int = 0
    checkers: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def run_lint(
    root: Optional[str] = None,
    paths: Optional[Sequence[str]] = None,
    checkers: Optional[Sequence[Checker]] = None,
    baseline_path: Optional[str] = DEFAULT_BASELINE,
    changed_only: Optional[str] = None,
) -> LintResult:
    """Run the suite; returns a :class:`LintResult`.

    ``changed_only``: a git ref — per-file checks are restricted to files
    that differ from it (project-level checks always run: they are
    cross-file, and a changed file can break an invariant anchored in an
    unchanged one).
    """
    root = root or default_root()
    rel_paths = collect_files(root, paths or DEFAULT_PATHS)
    changed: Optional[Set[str]] = None
    if changed_only is not None:
        changed = changed_files(root, changed_only)

    modules = [ModuleSource(root, rp) for rp in rel_paths]
    project = Project(root, modules)
    suite = list(checkers) if checkers is not None else all_checkers()

    raw: List[Finding] = []
    for mod in modules:
        if mod.parse_error is not None:
            raw.append(Finding(
                checker="core", rule="syntax-error", path=mod.path,
                line=mod.parse_error.lineno or 0,
                message=f"file does not parse: {mod.parse_error.msg}",
            ))
            continue
        if changed is not None and mod.path not in changed:
            continue
        for chk in suite:
            if chk.scope and not any(
                mod.path.startswith(p) for p in chk.scope
            ):
                continue
            raw.extend(chk.check_module(mod))
    for chk in suite:
        raw.extend(chk.check_project(project))

    result = LintResult(
        files_scanned=len(modules), checkers=[c.name for c in suite]
    )
    baseline = load_baseline(baseline_path) if baseline_path else {}
    seen_fp: Set[str] = set()
    for f in sorted(raw, key=lambda f: (f.path, f.line, f.rule)):
        mod = project.module(f.path)
        if mod is not None and mod.is_suppressed(f.rule, f.line):
            result.suppressed += 1
            continue
        if f.fingerprint in baseline:
            seen_fp.add(f.fingerprint)
            result.baselined.append(f)
            continue
        result.findings.append(f)
    result.stale_baseline = len(set(baseline) - seen_fp)
    return result
