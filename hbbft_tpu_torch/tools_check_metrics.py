"""Static metrics-contract check: ``python -m hbbft_tpu_torch.tools_check_metrics``.

Thin CLI shim over :mod:`hbbft_tpu_torch.lint.metric_convention` (the
checker is part of the hblint suite — ``python -m hbbft_tpu_torch.lint``
runs it together with the other checkers).  Same exit codes, violation
messages and OK line as the JAX package's repo-level
``tools_check_metrics.py``.

Asserts three things about the observability surface so it cannot rot
silently:

1. every metric name registered anywhere in the package follows the
   naming convention ``hbbft_<layer>_<name>`` with a known layer
   (``net`` | ``node`` | ``phase`` | ``sim`` | ``obs`` | ``chaos`` | ``sync``
   | ``guard`` | ``rbc`` | ``load`` | ``mesh``);
2. every registered metric name is documented in README.md's
   Observability section;
3. every :class:`hbbft_tpu_torch.fault_log.FaultKind` variant has a
   pre-initialized ``kind`` label on ``hbbft_node_faults_total`` (so a
   new fault kind cannot ship without appearing — at zero — in every
   node's exposition).

Exit status 0 iff all checks pass; findings go to stdout.
"""

from __future__ import annotations

import sys

from hbbft_tpu_torch.lint.core import default_root
from hbbft_tpu_torch.lint.metric_convention import (
    check_metrics,
    scan_registrations,
)

REPO = default_root()


def registered_metric_names():
    """(name, file) pairs for every registration in the package."""
    return [(name, path) for name, path, _line in scan_registrations(REPO)]


def main() -> int:
    problems, n_names, n_labels = check_metrics(REPO)
    if problems:
        print("tools_check_metrics: FAIL")
        for message, _path, _line in problems:
            print(f"  - {message}")
        return 1
    print(f"tools_check_metrics: OK — {n_names} metric names, "
          f"{n_labels} fault-kind labels, all documented and "
          f"convention-clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
