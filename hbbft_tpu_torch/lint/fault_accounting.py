"""Checker: exception paths must be accounted, not swallowed.

The fault accounting only works if every drop path feeds a counter —
a swallowed exception is an invisible Byzantine symptom.

- ``fault-except-pass`` (repo-wide) — ``except: pass`` and its morally
  identical spellings (``except Exception: pass``, ``except
  (..., Exception): pass``).  If ignoring really is correct, write
  ``contextlib.suppress(...)`` (greppable, reviewable) — or a narrow
  exception type plus an accounting call.
- ``fault-swallowed-drop`` (``net/`` and ``obs/``) — an ``except`` handler
  that neither re-raises nor performs any *accounting*: a counter
  increment (``x += 1``, ``.inc()``, ``.observe()``), a ``record_*``/
  ``*_count``/``*backoff*``/``*fail*``/``*fault*`` call, or a raise.
  Logging alone does not count — logs are not scrapeable, and the whole
  point of the fault counters is that a drop path shows up in
  ``/metrics``.  ``obs/`` is in scope since the flight recorder: a
  journal that silently drops records on disk errors is a black box that
  lies, so its failure paths must count
  ``hbbft_obs_flight_write_failures_total`` (and friends).  ``chaos/``
  is in scope since the campaign runner: shaped-away frames must count
  ``hbbft_chaos_frames_dropped_total`` and a failed cell must land in
  the report's error tally, never vanish.  ``net/statesync.py`` is in
  scope since the membership lifecycle landed: every failed chunk is a
  counted retry (``hbbft_sync_chunk_retries_total``), every donor
  switch a counted failover, and an abandoned transfer must count
  ``hbbft_sync_transfers_abandoned_total`` — a joiner that silently
  gives up is a wedged validator.  ``obs/critpath.py`` rides the
  ``obs/`` scope with the same contract at the analysis layer:
  send/receive pairs that never match, trace stages that never pair
  up, and unalignable processes are *counted* in the report's
  ``unmatched`` section — an attribution tool that silently drops the
  evidence it couldn't attribute would be worse than none.  The
  authenticated handshake extends the contract to identity refusals:
  every hello the acceptor turns away must increment
  ``hbbft_guard_auth_failures_total`` under its reason label
  (``bad_sig`` / ``unknown_key`` / ``no_auth`` / ``malformed`` /
  ``timeout`` / ``session`` / ``half_open``) and journal the
  attacker's endpoint — a spoof attempt that vanishes without a
  counter is an attack rehearsal nobody will see coming.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from hbbft_tpu_torch.lint.core import Checker, Finding, ModuleSource, register

_BROAD = {"Exception", "BaseException"}

_ACCOUNT_RE = re.compile(
    r"(inc|observe|count|record|fault|fail|backoff|abort|drop|suppress)",
    re.IGNORECASE,
)


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    for node in [t] + (list(t.elts) if isinstance(t, ast.Tuple) else []):
        if isinstance(node, ast.Name):
            names.append(node.id)
        elif isinstance(node, ast.Attribute):
            names.append(node.attr)
    return any(n in _BROAD for n in names)


def _body_is_pass(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(s, ast.Pass) for s in handler.body)


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


def _has_accounting(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.AugAssign):
            return True  # self.decode_failures += 1 and friends
        if isinstance(node, ast.Call) and _ACCOUNT_RE.search(
            _call_name(node)
        ):
            return True
    return False


@register
class FaultAccountingChecker(Checker):
    name = "fault-accounting"
    scope = ()  # except-pass is repo-wide; the drop rule self-scopes
    rules = {
        "fault-except-pass":
            "bare/broad `except: pass` — use contextlib.suppress(...) or "
            "a narrow type plus accounting",
        "fault-swallowed-drop":
            "except handler in net/ or obs/ drops input with no "
            "accounting (no raise, no counter increment, no "
            "record_*/backoff call)",
    }

    #: the drop rule only applies here — peer/client input paths, the
    #: flight recorder's journal-durability paths, and the chaos layer
    #: (a shaped/dropped frame the campaign can't account for would
    #: corrupt every liveness number the report emits)
    #: protocols/vid.py joins net/'s drop scope: a swallowed disperse /
    #: vote / cert failure is availability input dropped without the
    #: counted fault the retrievability argument depends on
    DROP_SCOPE = ("hbbft_tpu_torch/net/", "hbbft_tpu_torch/obs/",
                  "hbbft_tpu_torch/chaos/",
                  "hbbft_tpu_torch/protocols/vid.py")

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        tree = mod.tree
        if tree is None:
            return []
        out: List[Finding] = []
        in_drop_scope = any(
            mod.path.startswith(p) for p in self.DROP_SCOPE
        )
        for node in ast.walk(tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _body_is_pass(node) and _catches_broad(node):
                out.append(self.finding(
                    mod, "fault-except-pass", node,
                    "broad except with a bare pass body swallows every "
                    "error invisibly: use contextlib.suppress(...) or "
                    "narrow the type and account for the drop",
                ))
                continue
            if in_drop_scope and not _has_accounting(node):
                out.append(self.finding(
                    mod, "fault-swallowed-drop", node,
                    "exception path drops input without accounting: "
                    "increment a fault/drop counter (or re-raise) so the "
                    "drop shows in /metrics",
                ))
        return out
