"""Checker: network-fed collections must be bounded.

The overload-defense contract: any dict / list / set a ``net/`` or
``protocols/`` module GROWS from network-derived input must carry a cap
with a counted eviction — or a justified suppression.
A buffer that only ever appends is a memory-exhaustion lever for a
single Byzantine peer; the per-peer ingress budgets at the transport
only help if every layer above them is bounded too.

- ``bounded-ingress`` (``net/`` and ``protocols/``) — a statement that
  grows a ``self.*`` collection (``.append`` / ``.add`` / ``.extend`` /
  ``.insert``, including through ``.setdefault(...)`` chains) inside a
  function that receives network-derived input (a parameter named like
  ``sender_id`` / ``peer_id`` / ``payload`` / ``message`` / ``conn``),
  where the enclosing CLASS shows no bounding evidence for that
  attribute.

Bounding evidence for attribute ``X`` is any of, anywhere in the class:

- a ``len(self.X…)`` comparison (cap check);
- a removal call on it (``pop`` / ``popleft`` / ``popitem`` / ``clear``
  / ``discard`` / ``remove``) or a ``del self.X[…]`` statement;
- assignment replacing it wholesale (``self.X = …`` outside
  ``__init__`` — swap-and-drain buffers).

Growth whose added element is itself just the sender identity is exempt:
a set/dict keyed by peer id is bounded by peer cardinality, which the
``UnknownSender`` screening already caps.

Heuristic by design: a genuinely bounded-elsewhere site earns a
``# hblint: disable=bounded-ingress (<why>)`` with its justification —
the suppression IS the documentation the rule exists to force.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set

from hbbft_tpu_torch.lint.core import Checker, Finding, ModuleSource, register

#: parameter names that mark a function as handling network-derived
#: input (the protocols' handle_message surface, transport callbacks,
#: client admission)
_NET_PARAMS = frozenset({
    "sender_id", "sender", "peer_id", "peer", "payload", "data",
    "message", "msg", "frame", "hello", "conn", "tx",
    # the authenticated-handshake surface: everything a dialer hands
    # the acceptor BEFORE it is verified is network-derived input, and
    # anything grown from it pre-verification is a pre-auth memory
    # lever (the half-open budget only caps concurrency, not state)
    "nonce", "session", "sig", "signature", "auth",
})

#: the subset of network parameters that are peer IDENTITIES — only
#: these make a grown element "bounded by peer cardinality" (a message
#: or payload parameter is attacker-controlled content, never exempt)
_SENDER_PARAMS = frozenset({"sender_id", "sender", "peer_id", "peer"})

_GROW_METHODS = frozenset({"append", "add", "extend", "insert"})
_REMOVE_METHODS = frozenset({
    "pop", "popleft", "popitem", "clear", "discard", "remove",
})


def _self_attr_of(node: ast.AST) -> Optional[str]:
    """``self.X`` → ``"X"``; also unwraps one subscript level
    (``self.X[k]``) and ``self.X.setdefault(...)`` chains."""
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Call):
        # self.X.setdefault(...).append(...): the call's own func is
        # Attribute(setdefault) on self.X
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr == "setdefault":
            node = func.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


class _ClassEvidence(ast.NodeVisitor):
    """Collect, per class, the attributes with bounding evidence."""

    def __init__(self):
        self.bounded: Set[str] = set()
        self._in_init = False

    def visit_FunctionDef(self, node):
        prev, self._in_init = self._in_init, node.name == "__init__"
        self.generic_visit(node)
        self._in_init = prev

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call):
        func = node.func
        if isinstance(func, ast.Attribute):
            if func.attr in _REMOVE_METHODS:
                attr = _self_attr_of(func.value)
                if attr is not None:
                    self.bounded.add(attr)
            elif func.attr == "sort":
                # sort-then-del is the front-chop idiom; the del itself
                # also registers, this just tolerates helper splits
                attr = _self_attr_of(func.value)
                if attr is not None:
                    self.bounded.add(attr)
        if (isinstance(func, ast.Name) and func.id == "len"
                and node.args):
            attr = _self_attr_of(node.args[0])
            if attr is not None:
                self.bounded.add(attr)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete):
        for target in node.targets:
            attr = _self_attr_of(target)
            if attr is not None:
                self.bounded.add(attr)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if not self._in_init:
            for target in node.targets:
                # wholesale replacement (swap-and-drain) — but NOT a
                # keyed write, which is growth, not bounding
                if (isinstance(target, ast.Attribute)
                        and isinstance(target.value, ast.Name)
                        and target.value.id == "self"):
                    self.bounded.add(target.attr)
                if isinstance(target, ast.Tuple):
                    for elt in target.elts:
                        if (isinstance(elt, ast.Attribute)
                                and isinstance(elt.value, ast.Name)
                                and elt.value.id == "self"):
                            self.bounded.add(elt.attr)
        self.generic_visit(node)


def _function_params(fn) -> Set[str]:
    args = fn.args
    names = [a.arg for a in args.args + args.kwonlyargs
             + args.posonlyargs]
    if args.vararg:
        names.append(args.vararg.arg)
    return set(names)


def _is_sender_valued(call: ast.Call, params: Set[str]) -> bool:
    """Growth adding just the sender identity (bounded by peer
    cardinality) — ``self.X.add(sender_id)``."""
    if len(call.args) != 1:
        return False
    arg = call.args[0]
    return (isinstance(arg, ast.Name)
            and arg.id in (params & _SENDER_PARAMS))


@register
class BoundedIngressChecker(Checker):
    name = "bounded-ingress"
    # obs/audit_stream.py and obs/watch.py joined with the live health
    # plane: both consume unbounded external input (journal bytes,
    # scraped endpoints) in long-running processes, so their state must
    # show the same bounding evidence as the network ingress paths;
    # obs/perf.py samples forever in-process (its ring deques must stay
    # bounded the same way)
    scope = ("hbbft_tpu_torch/net/", "hbbft_tpu_torch/protocols/",
             "hbbft_tpu_torch/obs/audit_stream.py",
             "hbbft_tpu_torch/obs/watch.py",
             "hbbft_tpu_torch/obs/perf.py")
    rules = {
        "bounded-ingress":
            "a self.* collection grown from network-derived input in "
            "net/ or protocols/ shows no bounding evidence (no len() "
            "cap check, no removal, no wholesale replacement) — add a "
            "cap with a counted eviction or a justified suppression",
    }

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        tree = mod.tree
        if tree is None:
            return []
        out: List[Finding] = []
        for cls in ast.walk(tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            evidence = _ClassEvidence()
            evidence.visit(cls)
            out.extend(self._check_class(mod, cls, evidence.bounded))
        return out

    def _check_class(self, mod: ModuleSource, cls: ast.ClassDef,
                     bounded: Set[str]) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in ast.walk(cls):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            params = _function_params(fn)
            net_params = params & _NET_PARAMS
            if not net_params:
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                func = call.func
                if not (isinstance(func, ast.Attribute)
                        and func.attr in _GROW_METHODS):
                    continue
                attr = _self_attr_of(func.value)
                if attr is None or attr in bounded:
                    continue
                if _is_sender_valued(call, net_params):
                    continue
                out.append(self.finding(
                    mod, "bounded-ingress", call,
                    f"self.{attr}.{func.attr}(...) grows from network "
                    f"input ({fn.name}({', '.join(sorted(net_params))}"
                    f")) with no bounding evidence in "
                    f"{cls.name}: cap it with a counted eviction, or "
                    f"suppress with a justification",
                ))
        return out
