"""hblint output: human text and machine JSON.

The JSON document is the stable CI surface (``python -m hbbft_tpu_torch.lint
--json``)::

    {
      "version": 1,
      "tool": "hblint",
      "checkers": ["determinism", ...],
      "findings": [
        {"checker": ..., "rule": ..., "path": ..., "line": ...,
         "message": ..., "fingerprint": ...},
        ...
      ],
      "summary": {"findings": N, "baselined": B, "suppressed": S,
                  "files_scanned": F, "stale_baseline": T, "clean": bool}
    }

``findings`` holds only actionable (non-suppressed, non-baselined)
entries, most problems first is not implied — order is (path, line, rule).
"""

from __future__ import annotations

import json

from hbbft_tpu_torch.lint.core import LintResult

JSON_VERSION = 1


def render_text(result: LintResult, verbose_baseline: bool = False) -> str:
    lines = []
    for f in result.findings:
        lines.append(f"{f.location()}: [{f.rule}] {f.message}")
    if verbose_baseline:
        for f in result.baselined:
            lines.append(f"{f.location()}: [{f.rule}] (baselined) "
                         f"{f.message}")
    summary = (
        f"hblint: {'OK — ' if result.clean else ''}"
        f"{len(result.findings)} finding"
        f"{'' if len(result.findings) == 1 else 's'} "
        f"({len(result.baselined)} baselined, "
        f"{result.suppressed} suppressed) "
        f"across {result.files_scanned} files"
    )
    if result.stale_baseline:
        summary += (f"; {result.stale_baseline} stale baseline "
                    f"entr{'y' if result.stale_baseline == 1 else 'ies'}")
    lines.append(summary)
    return "\n".join(lines)


def render_json(result: LintResult) -> str:
    doc = {
        "version": JSON_VERSION,
        "tool": "hblint",
        "checkers": result.checkers,
        "findings": [f.as_dict() for f in result.findings],
        "baselined": [f.as_dict() for f in result.baselined],
        "summary": {
            "findings": len(result.findings),
            "baselined": len(result.baselined),
            "suppressed": result.suppressed,
            "files_scanned": result.files_scanned,
            "stale_baseline": result.stale_baseline,
            "clean": result.clean,
        },
    }
    return json.dumps(doc, indent=2, sort_keys=True)
