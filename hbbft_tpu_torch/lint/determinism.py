"""Checker: consensus-core determinism.

Every honest replica must fold the same inputs into the same Steps and the
same ledger, so code under ``protocols/``, ``parallel/`` and ``crypto/``
must not consult ambient nondeterminism — and ``chaos/`` joins the scope
because a chaos campaign cell must replay byte-identically from its seed
(a shaping decision drawn from wall time or the global RNG would make
every triaged failure unreproducible):

- ``det-wall-clock`` — wall-clock reads (``time.time``, ``time.monotonic``,
  ``datetime.now`` …).  Timing belongs to the drivers (net/, sim/, obs/),
  never to protocol state transitions.
- ``det-unseeded-random`` — module-level ``random.*`` calls (the shared,
  OS-seeded global RNG), ``os.urandom``, ``secrets.*``, ``uuid.uuid4``.
  Seeded ``random.Random(seed)`` instances are the sanctioned source
  (every protocol takes one); key-generation entry points (function name
  matching ``keygen|key_gen|generate``) are exempt — keys are *supposed*
  to be unpredictable.
- ``det-set-iteration`` — iterating a ``set``/``frozenset`` where the
  element order flows into wire encoding, hashing, or message fan-out
  (``encode_message``, ``to_bytes``, ``sha3*``, ``blob``, ``send`` …).
  Set iteration order is salted per process: two replicas running the
  same code can serialize the same logical value differently.  Route
  through ``sorted(...)`` instead.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Set, Tuple

from hbbft_tpu_torch.lint.core import Checker, Finding, ModuleSource, register

_WALL_CLOCK = {
    ("time", "time"), ("time", "time_ns"),
    ("time", "monotonic"), ("time", "monotonic_ns"),
    ("time", "perf_counter"), ("time", "perf_counter_ns"),
    ("time", "clock"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
}

#: random-module attributes that are fine to *reference* (classes and
#: non-drawing helpers); everything else on the module is the global RNG
_RANDOM_OK = {"Random", "SystemRandom"}

_KEYGEN_RE = re.compile(r"(keygen|key_gen|generate)", re.IGNORECASE)

#: call names whose argument/loop-body ordering is consensus-visible
_ORDER_SINKS = {
    "encode_message", "to_bytes", "blob", "node_id", "u32", "u64",
    "sha3_256", "sha3_256_host", "update", "digest", "pack",
    "send", "send_frame", "push_message", "send_message", "join",
}


class _ImportMap(ast.NodeVisitor):
    """alias → module for plain imports, local name → (module, attr) for
    from-imports — enough to resolve ``t.monotonic()`` after
    ``import time as t`` and ``urandom()`` after ``from os import urandom``.
    """

    def __init__(self):
        self.modules: Dict[str, str] = {}
        self.froms: Dict[str, Tuple[str, str]] = {}

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            self.modules[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        for a in node.names:
            if node.module:
                self.froms[a.asname or a.name] = (node.module, a.name)


def _resolve_call(node: ast.Call, imp: _ImportMap):
    """(module, attr) of a call when statically resolvable, else None."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        mod = imp.modules.get(f.value.id)
        if mod is not None:
            return (mod, f.attr)
        # datetime.datetime.now() resolves through the from-import too
        frm = imp.froms.get(f.value.id)
        if frm is not None:
            return (frm[1], f.attr)
    if isinstance(f, ast.Name):
        frm = imp.froms.get(f.id)
        if frm is not None:
            return frm
    return None


def _is_set_expr(node: ast.AST, set_vars: Set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        if node.func.id in ("set", "frozenset"):
            return True
    if isinstance(node, ast.Name) and node.id in set_vars:
        return True
    return False


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return ""


@register
class DeterminismChecker(Checker):
    name = "determinism"
    # chaos/ is in scope since the campaign runner: shaping decisions
    # and scenario schedules must come from the seeded RNG, or the
    # campaign's byte-identical-replay guarantee is fiction
    # ops/rs.py joined the scope with the backend-switched erasure hot
    # path: its per-backend STATS counters must stay plain ints (no
    # clocks) — all three backends must produce byte-identical parity,
    # and nondeterminism here forks the Merkle commitment
    # parallel/ includes parallel/mesh.py: the sharded epoch wrappers and
    # their per-phase STATS counters are subject to the same rule — a
    # mesh run and a single-device run must stay bit-identical, so the
    # collective accounting is computed statically from shapes, never
    # from clocks or traced values
    # obs/trace.py joined the scope with causal tracing: trace ids and
    # stage records ride the wire (tag 0x95) and must be derivable from
    # the tx bytes alone — a clock or RNG read here would fork the
    # byte-identical critpath reports of identical-seed sim runs
    # net/retrieve.py is clock-FREE by contract: every deadline decision
    # takes `now` from the caller (the runtime's pump), so the retrieval
    # state machine replays deterministically under the simulator — a
    # wall-clock read inside it would break that
    # obs/audit_stream.py joined with the streaming auditor: the
    # incremental core must produce byte-identical verdicts to the batch
    # CLI over the same journal bytes, regardless of feed order or poll
    # cadence — any clock or RNG read would fork that equivalence
    # obs/watch.py is clock-free by the same contract as net/retrieve:
    # Watchtower.tick(now, ...) takes the caller's clock (virtual in sim
    # cells, scripted in tests); only the CLI loop reads wall time,
    # under justified suppressions
    # obs/perf.py holds the performance plane to the same contract:
    # sample(now)/segment_means are pure folds over counter snapshots;
    # the single wall-clock read lives in maybe_sample under a
    # justified suppression
    scope = ("hbbft_tpu_torch/protocols/", "hbbft_tpu_torch/parallel/",
             "hbbft_tpu_torch/crypto/", "hbbft_tpu_torch/chaos/",
             "hbbft_tpu_torch/ops/rs.py", "hbbft_tpu_torch/obs/trace.py",
             "hbbft_tpu_torch/net/retrieve.py",
             "hbbft_tpu_torch/obs/audit_stream.py",
             "hbbft_tpu_torch/obs/watch.py", "hbbft_tpu_torch/obs/perf.py")
    rules = {
        "det-wall-clock":
            "wall-clock read in consensus-core code (time.time, "
            "time.monotonic, datetime.now, ...)",
        "det-unseeded-random":
            "global/OS-seeded randomness (module-level random.*, "
            "os.urandom, secrets, uuid4) outside key-generation entry "
            "points",
        "det-set-iteration":
            "set/frozenset iteration order flowing into wire encoding, "
            "hashing, or message fan-out",
    }

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        tree = mod.tree
        if tree is None:
            return []
        imp = _ImportMap()
        imp.visit(tree)
        out: List[Finding] = []
        self._visit(mod, tree, imp, func_stack=[], set_vars=set(), out=out)
        return out

    # -- recursive walk (one visit per node, function stack tracked) -------

    def _visit(self, mod, node, imp, func_stack, set_vars, out) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._visit(mod, child, imp, func_stack + [child.name],
                            set(), out)
                continue
            # track names assigned from set-typed expressions in this scope
            if isinstance(child, ast.Assign) and len(child.targets) == 1:
                tgt = child.targets[0]
                if isinstance(tgt, ast.Name):
                    if _is_set_expr(child.value, set_vars):
                        set_vars.add(tgt.id)
                    else:
                        set_vars.discard(tgt.id)
            self._check_node(mod, child, imp, func_stack, set_vars, out)
            self._visit(mod, child, imp, func_stack, set_vars, out)

    def _check_node(self, mod, node, imp, func_stack, set_vars, out) -> None:
        if isinstance(node, ast.Call):
            res = _resolve_call(node, imp)
            if res in _WALL_CLOCK:
                out.append(self.finding(
                    mod, "det-wall-clock", node,
                    f"wall-clock read {res[0]}.{res[1]}() in "
                    f"consensus-core code: replicas must not branch "
                    f"on local time",
                ))
            elif res is not None and self._is_global_random(res):
                if not any(_KEYGEN_RE.search(fn) for fn in func_stack):
                    out.append(self.finding(
                        mod, "det-unseeded-random", node,
                        f"{res[0]}.{res[1]}() draws from global/OS "
                        f"entropy: use a caller-supplied seeded "
                        f"random.Random (or move into a key-generation "
                        f"entry point)",
                    ))
            self._check_set_arg(mod, node, set_vars, out)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self._check_set_loop(mod, node, set_vars, out)

    @staticmethod
    def _is_global_random(res: Tuple[str, str]) -> bool:
        mod, attr = res
        if mod == "random" and attr not in _RANDOM_OK:
            return True
        if (mod, attr) == ("os", "urandom"):
            return True
        if mod == "secrets":
            return True
        if (mod, attr) == ("uuid", "uuid4"):
            return True
        return False

    def _check_set_loop(self, mod, node, set_vars, out) -> None:
        if not _is_set_expr(node.iter, set_vars):
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and _call_name(sub) in _ORDER_SINKS:
                out.append(self.finding(
                    mod, "det-set-iteration", node,
                    f"loop over a set feeds order-sensitive call "
                    f"{_call_name(sub)}(): iterate sorted(...) so every "
                    f"replica serializes identically",
                ))
                return

    def _check_set_arg(self, mod, node, set_vars, out) -> None:
        if _call_name(node) not in _ORDER_SINKS:
            return
        for arg in node.args:
            direct_set = _is_set_expr(arg, set_vars)
            comp_over_set = isinstance(
                arg, (ast.GeneratorExp, ast.ListComp)
            ) and any(
                _is_set_expr(g.iter, set_vars) for g in arg.generators
            )
            if direct_set or comp_over_set:
                out.append(self.finding(
                    mod, "det-set-iteration", node,
                    f"set iteration order reaches order-sensitive call "
                    f"{_call_name(node)}(): wrap the set in sorted(...)",
                ))
                return
