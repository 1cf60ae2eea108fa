"""Checker: the observability metrics contract (ex ``tools_check_metrics``).

The metrics static pass, rehosted on the lint framework
(``python -m hbbft_tpu_torch.tools_check_metrics`` is a thin CLI shim with
byte-identical output).  Three invariants over the package:

- every registered metric name follows
  ``hbbft_<net|node|phase|sim|obs|chaos|sync|guard|rbc|load|mesh|gw|vid>_<name>``;
- every registered metric name is documented in README.md's Observability
  section;
- every :class:`~hbbft_tpu_torch.fault_log.FaultKind` variant has a
  pre-initialized ``kind`` label on ``hbbft_node_faults_total``.

Problem *messages* are kept identical to the original tool so its tier-1
behavior cannot drift while the plumbing changes underneath.
"""

from __future__ import annotations

import os
import re
from typing import Iterable, List, Optional, Tuple

from hbbft_tpu_torch.lint.core import Checker, Finding, Project, register

NAME_CONVENTION = re.compile(
    r"^hbbft_(net|node|phase|sim|obs|chaos|sync|guard|rbc|load|mesh"
    r"|pump|trace|gw|vid|health|perf|ctrl)"
    r"_[a-z][a-z0-9_]*$"
)

# a registration is a .counter( / .gauge( / .histogram( call whose first
# argument is a string literal starting with hbbft_ (possibly on the next
# line); DEFAULT.counter(...) in sim/trace.py matches the same shape
_REG_RE = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*[\r\n]?\s*['\"](hbbft_[A-Za-z0-9_]*)['\"]",
    re.MULTILINE,
)


def scan_registrations(root: str) -> List[Tuple[str, str, int]]:
    """(name, repo-relative file, line) for every registration in the
    package under ``root``."""
    paths = []
    pkg = os.path.join(root, "hbbft_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            if fn.endswith(".py"):
                paths.append(os.path.join(dirpath, fn))
    out = []
    for path in paths:
        with open(path, encoding="utf-8") as fh:
            src = fh.read()
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        for m in _REG_RE.finditer(src):
            line = src.count("\n", 0, m.start()) + 1
            out.append((m.group(1), rel, line))
    return out


def check_metrics(root: str, check_faults: bool = True):
    """The full contract check.

    Returns ``(problems, n_names, n_fault_labels)`` where ``problems`` is a
    list of ``(message, path, line)`` — messages byte-identical to the
    original ``tools_check_metrics.py`` so the shim's output cannot drift.
    """
    problems: List[Tuple[str, Optional[str], int]] = []
    regs = scan_registrations(root)
    if not regs:
        problems.append((
            "no metric registrations found at all — the "
            "scanner regex is broken", None, 0,
        ))
    readme_path = os.path.join(root, "README.md")
    readme = ""
    if os.path.exists(readme_path):
        with open(readme_path, encoding="utf-8") as fh:
            readme = fh.read()

    seen = {}
    first_at = {}
    for name, path, line in regs:
        seen.setdefault(name, set()).add(path)
        first_at.setdefault(name, (path, line))
    for name in sorted(seen):
        where = ", ".join(sorted(seen[name]))
        path, line = first_at[name]
        if not NAME_CONVENTION.match(name):
            problems.append((
                f"{name} ({where}): violates the naming convention "
                f"hbbft_<net|node|phase|sim|obs|chaos|sync|guard>_<name>",
                path, line,
            ))
        if f"`{name}`" not in readme and name not in readme:
            problems.append((
                f"{name} ({where}): not documented in README.md's "
                f"Observability section", path, line,
            ))

    n_labels = 0
    if check_faults:
        # FaultKind coverage: the runtime pre-initializes one label per
        # variant via obs.metrics.fault_counter — verify against the enum
        from hbbft_tpu_torch.fault_log import FaultKind
        from hbbft_tpu_torch.obs.metrics import Registry, fault_counter

        reg = Registry()
        c = fault_counter(reg)
        labeled = {labels["kind"] for labels, _child in c.series()}
        n_labels = len(labeled)
        for k in FaultKind:
            if k.name not in labeled:
                problems.append((
                    f"FaultKind.{k.name}: no pre-initialized label on "
                    f"hbbft_node_faults_total (obs.metrics.fault_counter)",
                    "hbbft_tpu_torch/obs/metrics.py", 0,
                ))
    return problems, len(seen), n_labels


@register
class MetricConventionChecker(Checker):
    name = "metric-convention"
    scope = ("hbbft_tpu_torch/",)
    rules = {
        "metric-convention":
            "metric naming convention, README documentation, and "
            "FaultKind label coverage (the tools_check_metrics contract)",
    }

    def check_project(self, project: Project) -> Iterable[Finding]:
        problems, _n, _l = check_metrics(project.root)
        out = []
        for message, path, line in problems:
            mod = project.module(path) if path else None
            snippet = mod.line_at(line) if (mod and line) else ""
            out.append(Finding(
                checker=self.name, rule="metric-convention",
                path=path or "hbbft_tpu_torch/obs/metrics.py", line=line,
                message=message, snippet=snippet,
            ))
        return out
