"""The universal state-machine contract.

Mirrors the reference's ``src/traits.rs`` (older ``src/messaging.rs``):
everything in the stack — broadcast, agreement, subset, honey badger — is an
object that consumes an input or a message and returns a :class:`Step`
containing outputs, a fault log, and outgoing :class:`TargetedMessage`\\ s.
No I/O, no threads, no clocks: the caller owns the event loop
(``sim.virtual_net.VirtualNet``; the batched array drivers of
``parallel/`` run the same protocol as tensor rounds instead).

The port's copy of the JAX package's ``traits.py``; the protocols of
``protocols/`` and the simulator of ``sim/`` build on it.

Reference items mirrored here:
``ConsensusProtocol`` (assoc. types NodeId/Input/Output/Message/Error; methods
``handle_input``/``handle_message``/``terminated``/``our_id``),
``Step { output, fault_log, messages }`` with ``extend``/``map``/``join``,
``TargetedMessage { target, message }`` and ``Target::{All, AllExcept, Nodes, Node}``.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import (
    Any,
    Callable,
    FrozenSet,
    Generic,
    Hashable,
    Iterable,
    List,
    Optional,
    TypeVar,
)

from hbbft_tpu_torch.fault_log import FaultKind, FaultLog

NodeId = Hashable
M = TypeVar("M")  # message type
O = TypeVar("O")  # output type


class Target:
    """Message routing directive.  Reference: ``src/traits.rs :: Target``.

    Construct via the factory classmethods: ``Target.all()``,
    ``Target.node(id)``, ``Target.nodes(ids)``, ``Target.all_except(ids)``.
    The caller (simulator / network layer) resolves the target set against the
    current membership; the protocols never enumerate peers themselves.
    """

    __slots__ = ("kind", "ids")

    ALL = "all"
    NODES = "nodes"
    ALL_EXCEPT = "all_except"

    def __init__(self, kind: str, ids: Optional[FrozenSet[NodeId]] = None):
        self.kind = kind
        self.ids = ids

    @classmethod
    def all(cls) -> "Target":
        return cls(cls.ALL)

    @classmethod
    def node(cls, node_id: NodeId) -> "Target":
        return cls(cls.NODES, frozenset((node_id,)))

    @classmethod
    def nodes(cls, ids: Iterable[NodeId]) -> "Target":
        return cls(cls.NODES, frozenset(ids))

    @classmethod
    def all_except(cls, ids: Iterable[NodeId]) -> "Target":
        return cls(cls.ALL_EXCEPT, frozenset(ids))

    def resolve(self, all_ids: Iterable[NodeId], our_id: NodeId) -> List[NodeId]:
        """Expand to the concrete destination list (never includes ``our_id``)."""
        if self.kind == self.ALL:
            return [n for n in all_ids if n != our_id]
        if self.kind == self.ALL_EXCEPT:
            return [n for n in all_ids if n != our_id and n not in self.ids]
        return [n for n in all_ids if n in self.ids and n != our_id]

    def contains(self, node_id: NodeId) -> bool:
        if self.kind == self.ALL:
            return True
        if self.kind == self.ALL_EXCEPT:
            return node_id not in self.ids
        return node_id in self.ids

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, Target)
            and self.kind == other.kind
            and self.ids == other.ids
        )

    def __hash__(self) -> int:
        return hash((self.kind, self.ids))

    def __repr__(self) -> str:
        if self.kind == self.ALL:
            return "Target.all()"
        if self.kind == self.ALL_EXCEPT:
            return f"Target.all_except({sorted(self.ids, key=repr)!r})"
        return f"Target.nodes({sorted(self.ids, key=repr)!r})"


@dataclass(slots=True)
class TargetedMessage(Generic[M]):
    """A message plus its routing directive.

    Reference: ``src/traits.rs :: TargetedMessage``.
    """

    target: Target
    message: M

    def map(self, f: Callable[[M], Any]) -> "TargetedMessage":
        return TargetedMessage(self.target, f(self.message))


@dataclass(slots=True)
class Step(Generic[M, O]):
    """The result of handling one input or message.

    Reference: ``src/traits.rs :: Step`` — ``output: Vec<O>``, ``fault_log``,
    ``messages: Vec<TargetedMessage>``, combinators ``extend``/``join``/``map``.
    """

    output: List[O] = field(default_factory=list)
    fault_log: FaultLog = field(default_factory=FaultLog)
    messages: List[TargetedMessage] = field(default_factory=list)

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_output(cls, out: O) -> "Step":
        return cls(output=[out])

    @classmethod
    def from_fault(cls, node_id: NodeId, kind: FaultKind) -> "Step":
        return cls(fault_log=FaultLog.init(node_id, kind))

    @classmethod
    def from_msg(cls, msg: TargetedMessage) -> "Step":
        return cls(messages=[msg])

    # -- combinators -------------------------------------------------------
    def extend(self, other: "Step") -> "Step":
        """Absorb ``other`` into ``self`` (in place), returning ``self``."""
        self.output.extend(other.output)
        self.fault_log.extend(other.fault_log)
        self.messages.extend(other.messages)
        return self

    def join(self, other: "Step") -> "Step":
        return self.extend(other)

    def map(
        self,
        msg_f: Callable[[M], Any],
        out_f: Optional[Callable[[O], Any]] = None,
    ) -> "Step":
        """Rewrap messages (and optionally outputs) IN PLACE, returning
        ``self``.

        This is how an outer protocol lifts an inner protocol's step into
        its own message/output types (reference ``Step::map``).  The
        receiver is CONSUMED: every call site discards it in favor of the
        result, and the QHB wrapper chain maps each step three times per
        message — copying output/fault/message lists at every layer was a
        measurable slice of the per-message hot path.
        """
        if out_f:
            self.output = [out_f(o) for o in self.output]
        self.messages = [tm.map(msg_f) for tm in self.messages]
        return self

    def send(self, target: Target, message: M) -> "Step":
        self.messages.append(TargetedMessage(target, message))
        return self

    def send_all(self, message: M) -> "Step":
        return self.send(Target.all(), message)

    def send_to(self, node_id: NodeId, message: M) -> "Step":
        return self.send(Target.node(node_id), message)

    def fault(self, node_id: NodeId, kind: FaultKind) -> "Step":
        self.fault_log.append(node_id, kind)
        return self

    def __repr__(self) -> str:
        return (
            f"Step(output={self.output!r}, faults={len(self.fault_log)}, "
            f"messages={len(self.messages)})"
        )


class StepObserver:
    """Observability hook threaded through :class:`Step` processing.

    The protocols stay sans-I/O: they never call this themselves.  A
    driver that pumps Steps (``sim.virtual_net.VirtualNet``, per delivery)
    reports each inbound message and the resulting Step through one of
    these, so a tracer can attribute time to protocol phases without
    touching protocol code.

    Both methods are optional no-ops; ``t`` is a monotonic timestamp the
    driver may supply (the observer stamps its own clock when omitted).
    """

    def on_message(self, sender_id: NodeId, message: Any,
                   t: Optional[float] = None) -> None:
        """One inbound protocol message, before it is handled."""

    def on_input(self, sender_id: NodeId, input: Any,
                 t: Optional[float] = None) -> None:
        """A locally-admitted input (contribution), before it is
        handled."""

    def on_step(self, step: "Step", t: Optional[float] = None) -> None:
        """The Step the protocol returned (outputs close epochs)."""

    def on_note(self, kind: str, detail: str,
                t: Optional[float] = None) -> None:
        """An out-of-band driver lifecycle event (``start`` / ``restart``
        / ``replay_gap`` / ``crash`` / ``stop``) — protocol-free context
        the flight recorder journals alongside the message stream."""


class ConsensusProtocol(abc.ABC, Generic[M, O]):
    """Abstract sans-I/O consensus state machine.

    Reference: ``src/traits.rs :: ConsensusProtocol`` (older name
    ``DistAlgorithm``).  Implementations are single-threaded and
    deterministic; randomness, time, and delivery order all live with the
    caller.
    """

    @abc.abstractmethod
    def handle_input(self, input: Any) -> Step:
        """Propose/insert our own input into the protocol."""

    @abc.abstractmethod
    def handle_message(self, sender_id: NodeId, message: M) -> Step:
        """Process one message received from ``sender_id``.

        ``message`` must be one of the protocol's message types: the wire
        codec / simulator owns that guarantee (the reference gets it from
        serde — untypeable bytes never reach the protocol).  A wrong *type*
        raises ``TypeError``; Byzantine *content* in a well-typed message
        never raises — it is recorded in the step's fault log.
        """

    @abc.abstractmethod
    def terminated(self) -> bool:
        """True once the protocol can make no further progress."""

    @abc.abstractmethod
    def our_id(self) -> NodeId:
        """This node's identifier."""
