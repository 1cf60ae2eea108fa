"""hblint — AST-based static analysis for the hbbft-tpu codebase.

Dependency-free (stdlib ``ast`` only, plus an import of the package under
analysis for the registry cross-checks).  Five checkers guard the
invariants no unit test can pin down exhaustively:

==================  =====================================================
checker             guards
==================  =====================================================
determinism         consensus core free of wall-clock / global RNG / set
                    iteration order leaking into encoding or fan-out
asyncio-hazard      net/obs event loop: no lost coroutines or tasks, no
                    blocking calls, no locks held across network awaits
wire-completeness   every protocol message registered, uniquely tagged,
                    decodable, frozen and hashable
fault-accounting    every drop path counted; no silent except: pass
metric-convention   metric naming + README docs + FaultKind labels
==================  =====================================================

CLI: ``python -m hbbft_tpu_torch.lint [--json] [--changed-only GITREF]
…`` — runs as a tier-1 test over the repo (``tests/test_torch_lint.py``).
Programmatic: :func:`run_lint` returns a :class:`LintResult`.

Suppress one finding with ``# hblint: disable=<rule>  (justification)``
on the flagged line, a whole file with ``# hblint: disable-file=<rule>``;
grandfather deliberate findings in ``hbbft_tpu_torch/lint/baseline.txt``
(``--write-baseline`` regenerates, then edit the justifications).
"""

from hbbft_tpu_torch.lint.core import (  # noqa: F401
    Checker,
    Finding,
    LintResult,
    ModuleSource,
    Project,
    all_checkers,
    register,
    rule_table,
    run_lint,
)
from hbbft_tpu_torch.lint.reporters import (  # noqa: F401
    render_json,
    render_text,
)

__all__ = [
    "Checker", "Finding", "LintResult", "ModuleSource", "Project",
    "all_checkers", "register", "rule_table", "run_lint",
    "render_json", "render_text",
]
