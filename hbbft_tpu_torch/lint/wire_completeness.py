"""Checker: the wire codec covers the whole message surface.

``protocols/wire.py::_lazy_register`` is the single registry every byte on
the wire flows through; an unregistered message type raises only when it
is first *sent*, and an unhashable one breaks the replay-log dedup in
``net/runtime.py`` only when a peer *reconnects* — both far too late.
This checker front-loads the contract:

- ``wire-duplicate-tag`` — two classes registered under one tag byte;
- ``wire-missing-codec`` — a class with an encoder but no decoder for its
  tag (or a decoder tag no class encodes to);
- ``wire-not-frozen`` / ``wire-not-hashable`` — every registered class
  must be a ``@dataclass(frozen=True)`` with a working ``__hash__``
  (``net/runtime.py`` dedups replay-log entries by value; an unhashable
  message turns a peer reconnect into a TypeError);
- ``wire-unregistered`` — an AST sweep over ``protocols/``: any
  ``@dataclass`` whose name looks like a message (``*Msg``, ``*Message``,
  ``*Wrap``) but is not in the registry.  Types that deliberately ride
  *inside* another registered envelope carry a one-line suppression at
  the class definition.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

from hbbft_tpu_torch.lint.core import (
    Checker,
    Finding,
    ModuleSource,
    Project,
    register,
)

_MSG_NAME_RE = re.compile(r".*(Msg|Message|Wrap)$")

_WIRE_PATH = "hbbft_tpu_torch/protocols/wire.py"


def _class_anchor(project: Project, cls) -> Tuple[str, int, str]:
    """(path, line, snippet) of a class definition inside the project;
    falls back to wire.py:0 when the defining module is not scanned."""
    mod_name = getattr(cls, "__module__", "") or ""
    rel = mod_name.replace(".", "/") + ".py"
    mod = project.module(rel)
    if mod is not None and mod.tree is not None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef) and node.name == cls.__name__:
                return rel, node.lineno, mod.line_at(node.lineno)
    return _WIRE_PATH, 0, ""


@register
class WireCompletenessChecker(Checker):
    name = "wire-completeness"
    scope = ("hbbft_tpu_torch/protocols/",)
    rules = {
        "wire-duplicate-tag":
            "two message classes registered under the same wire tag",
        "wire-missing-codec":
            "registered message lacks an encoder/decoder pair",
        "wire-not-frozen":
            "wire-registered message class is not @dataclass(frozen=True)",
        "wire-not-hashable":
            "wire-registered message class has no usable __hash__ "
            "(breaks replay-log dedup in net/runtime.py)",
        "wire-unregistered":
            "message-shaped dataclass in protocols/ is not registered "
            "with the wire codec",
        "wire-import-error":
            "could not import the wire registry to cross-check it",
    }

    # -- per-file AST sweep -------------------------------------------------

    def check_module(self, mod: ModuleSource) -> Iterable[Finding]:
        # the AST sweep needs the registered-name set; done in
        # check_project so the registry is imported exactly once
        return ()

    def ast_unregistered(self, mod: ModuleSource,
                         registered: Set[str]) -> List[Finding]:
        """Message-shaped dataclasses of ``mod`` missing from
        ``registered`` (injectable for fixture tests)."""
        out: List[Finding] = []
        tree = mod.tree
        if tree is None:
            return out
        for node in ast.walk(tree):
            if not isinstance(node, ast.ClassDef):
                continue
            if not _MSG_NAME_RE.match(node.name):
                continue
            if not any(self._is_dataclass_deco(d) for d in
                       node.decorator_list):
                continue
            if node.name in registered:
                continue
            out.append(self.finding(
                mod, "wire-unregistered", node,
                f"dataclass {node.name} looks like a protocol message "
                f"but has no wire registration: add it to "
                f"wire._lazy_register (or suppress here if it only ever "
                f"rides inside another registered envelope)",
            ))
        return out

    @staticmethod
    def _is_dataclass_deco(deco: ast.AST) -> bool:
        if isinstance(deco, ast.Call):
            deco = deco.func
        if isinstance(deco, ast.Name):
            return deco.id == "dataclass"
        if isinstance(deco, ast.Attribute):
            return deco.attr == "dataclass"
        return False

    # -- registry invariants ------------------------------------------------

    def registry_findings(self, msg_tags: Dict[type, Tuple[int, object]],
                          msg_decoders: Dict[int, object],
                          locate) -> List[Finding]:
        """Pure invariant check over a (tags, decoders) registry;
        ``locate(cls) -> (path, line, snippet)`` anchors findings."""
        out: List[Finding] = []

        def f(rule: str, cls: Optional[type], message: str) -> Finding:
            path, line, snippet = (
                locate(cls) if cls is not None else (_WIRE_PATH, 0, "")
            )
            return Finding(checker=self.name, rule=rule, path=path,
                           line=line, message=message, snippet=snippet)

        by_tag: Dict[int, List[type]] = {}
        for cls, (tag, _enc) in msg_tags.items():
            by_tag.setdefault(tag, []).append(cls)
        for tag, classes in sorted(by_tag.items()):
            if len(classes) > 1:
                names = ", ".join(sorted(c.__name__ for c in classes))
                out.append(f(
                    "wire-duplicate-tag", classes[0],
                    f"tag 0x{tag:02x} registered for multiple classes: "
                    f"{names}",
                ))
            if tag not in msg_decoders:
                out.append(f(
                    "wire-missing-codec", classes[0],
                    f"{classes[0].__name__} (tag 0x{tag:02x}) has an "
                    f"encoder but no decoder",
                ))
        for tag in sorted(set(msg_decoders) - set(by_tag)):
            out.append(f(
                "wire-missing-codec", None,
                f"decoder registered for tag 0x{tag:02x} but no class "
                f"encodes to it",
            ))
        for cls in msg_tags:
            params = getattr(cls, "__dataclass_params__", None)
            if params is None or not params.frozen:
                out.append(f(
                    "wire-not-frozen", cls,
                    f"wire-registered {cls.__name__} must be "
                    f"@dataclass(frozen=True): mutable messages break "
                    f"value semantics across the codec and the replay "
                    f"log",
                ))
            if getattr(cls, "__hash__", None) is None:
                out.append(f(
                    "wire-not-hashable", cls,
                    f"wire-registered {cls.__name__} is unhashable "
                    f"(eq without hash): net/runtime.py's replay-log "
                    f"dedup raises TypeError on the first reconnect",
                ))
        return out

    # -- project entry ------------------------------------------------------

    def check_project(self, project: Project) -> Iterable[Finding]:
        try:
            from hbbft_tpu_torch.protocols import wire

            wire.ensure_registered()
            msg_tags = dict(wire._MSG_TAGS)
            msg_decoders = dict(wire._MSG_DECODERS)
        except Exception as exc:  # pragma: no cover - import environment
            return [Finding(
                checker=self.name, rule="wire-import-error",
                path=_WIRE_PATH, line=0,
                message=f"cannot import/inspect the wire registry: "
                        f"{exc!r}",
            )]
        out = self.registry_findings(
            msg_tags, msg_decoders,
            locate=lambda cls: _class_anchor(project, cls),
        )
        registered = {cls.__name__ for cls in msg_tags}
        for mod in project.in_scope(self.scope):
            out.extend(self.ast_unregistered(mod, registered))
        return out
