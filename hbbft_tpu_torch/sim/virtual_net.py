"""The deterministic in-process message-pump simulator.

Reference: ``tests/net/mod.rs :: VirtualNet / NetBuilder`` — the event loop
that owns message delivery for the sans-I/O protocol objects.  ``crank()``
delivers exactly one message (chosen by the adversary), feeds it to the
destination node, fans out the resulting ``Step.messages`` (resolving
``Target::All`` etc. against the membership), and records outputs and faults.

Faulty nodes here are *crash/byzantine-by-adversary*: their outgoing messages
pass through ``Adversary.tamper`` (which may rewrite or drop them), and they
can be driven by custom algorithms supplied via ``NetBuilder.faulty``.

The port's copy of the JAX package's ``sim/virtual_net.py``.  The loop is
host work; the protocol objects it drives carry their own ``device``.
``NetBuilder.shape`` attaches link shaping (:mod:`hbbft_tpu_torch.chaos.link`):
shaped messages wait in a held set until the virtual clock reaches them.
``NetBuilder.flight`` attaches a flight recorder to every node, on a
logical clock.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

from hbbft_tpu_torch.fault_log import Fault, FaultLog
from hbbft_tpu_torch.sim.adversary import Adversary, NullAdversary
from hbbft_tpu_torch.traits import Step, TargetedMessage

NodeId = Hashable


class CrankError(Exception):
    """Limit exceeded (reference: ``tests/net/err.rs :: CrankError``)."""


@dataclass
class NetworkMessage:
    sender: NodeId
    to: NodeId
    payload: Any
    #: earliest virtual delivery time (set by link shaping; 0 = now).
    #: The cost model floors the receiver's clock here, so shaped
    #: latency shows up in per-cell virtual latency numbers.
    at: float = 0.0


@dataclass
class Node:
    node_id: NodeId
    algorithm: Any  # a ConsensusProtocol
    is_faulty: bool = False
    outputs: List[Any] = field(default_factory=list)
    faults_observed: FaultLog = field(default_factory=FaultLog)


class VirtualNet:
    def __init__(
        self,
        nodes: Dict[NodeId, Node],
        adversary: Optional[Adversary] = None,
        message_limit: Optional[int] = None,
        crank_limit: Optional[int] = None,
        trace: Optional["EventLog"] = None,
        cost_model: Optional["CostModel"] = None,
        observers: Optional[Dict[NodeId, Any]] = None,
        shaper: Optional[Any] = None,
    ):
        self.nodes = nodes
        self.queue: List[NetworkMessage] = []
        self.adversary = adversary or NullAdversary()
        self.message_limit = message_limit
        self.crank_limit = crank_limit
        self.messages_delivered = 0
        self.cranks = 0
        self.trace = trace
        self.cost_model = cost_model
        # the shared link-shaping hook (chaos.link.LinkShaper): shaped
        # messages wait in _held until the virtual clock reaches their
        # delivery time; [] from the shaper means the frame was dropped
        self.shaper = shaper
        self._held: List[Tuple[float, int, NetworkMessage]] = []
        self._held_seq = 0
        # messages removed by the adversary's network-level gate
        # (filter_message returning None) — censorship/eclipse/crash
        self.adversary_filtered = 0
        # per-node traits.StepObserver hooks: each delivery/input to node i
        # is reported to observers[i]
        self.observers: Dict[NodeId, Any] = observers or {}
        # per-node clocks: nodes work in parallel, so simulated wall time is
        # the max over nodes, not the sum (mirrors the reference example's
        # per-node timing model)
        self.node_times: Dict[NodeId, float] = {}
        self.virtual_time = 0.0

    # -- topology -----------------------------------------------------------

    def node_ids(self) -> List[NodeId]:
        return sorted(self.nodes.keys(), key=repr)

    def correct_ids(self) -> List[NodeId]:
        return [n for n in self.node_ids() if not self.nodes[n].is_faulty]

    # -- driving ------------------------------------------------------------

    def send_input(self, node_id: NodeId, input: Any) -> None:
        """Feed an input to a node and fan out its step."""
        node = self.nodes[node_id]
        obs = self.observers.get(node_id)
        # with a cost model the virtual clock is meaningful: stamp the
        # ingress (and the step) with it so per-tx traces and spans
        # share the journal's timebase; without one, None → each
        # observer falls back to its own (logical) clock
        t = self.virtual_time if self.cost_model is not None else None
        if obs is not None:
            on_input = getattr(obs, "on_input", None)
            if on_input is not None:
                on_input(node_id, input, t)
        step = node.algorithm.handle_input(input)
        if obs is not None:
            obs.on_step(step, t)
        self._process_step(node, step)

    def crank(self) -> Optional[NetworkMessage]:
        """Deliver exactly one message; None if nothing is deliverable
        (both the live queue and the shaper's held set are empty)."""
        self.adversary.pre_crank(self)
        self._release_due()
        if not self.queue:
            if not self._held:
                return None
            # every in-flight message is future-dated (a shaped lull):
            # event-driven clock jump to the earliest delivery time
            self.virtual_time = self._held[0][0]
            self._release_due()
        self.cranks += 1
        if self.crank_limit is not None and self.cranks > self.crank_limit:
            raise CrankError(f"crank limit {self.crank_limit} exceeded")
        idx = self.adversary.pick_message(self)
        msg = self.queue.pop(idx)
        dest = self.nodes.get(msg.to)
        if dest is None:
            return msg
        nbytes = 0
        t_deliver: Optional[float] = None
        if self.trace is not None or self.cost_model is not None:
            from hbbft_tpu_torch.sim.trace import wire_size

            nbytes = wire_size(msg.payload)
            if self.cost_model is not None:
                # the virtual delivery time is charged BEFORE the handler
                # runs, so observers stamp events with the time they
                # happened on the virtual clock
                t_deliver = max(self.node_times.get(msg.to, 0.0), msg.at) \
                    + self.cost_model.charge(nbytes)
        obs = self.observers.get(msg.to)
        if obs is not None:
            obs.on_message(msg.sender, msg.payload, t_deliver)
        step = dest.algorithm.handle_message(msg.sender, msg.payload)
        if obs is not None:
            obs.on_step(step, t_deliver)
        self._process_step(dest, step)
        self.messages_delivered += 1
        if t_deliver is not None:
            self.node_times[msg.to] = t_deliver
            self.virtual_time = max(self.virtual_time, t_deliver)
        if self.trace is not None:
            from hbbft_tpu_torch.sim.trace import CrankEvent, msg_type_path

            self.trace.record(CrankEvent(
                crank=self.cranks,
                sender=msg.sender,
                dest=msg.to,
                msg_type=msg_type_path(msg.payload),
                wire_bytes=nbytes,
                outputs=len(step.output),
                faults=len(step.fault_log),
                virtual_time=self.virtual_time,
            ))
        if (
            self.message_limit is not None
            and self.messages_delivered > self.message_limit
        ):
            raise CrankError(f"message limit {self.message_limit} exceeded")
        return msg

    def crank_until(
        self, pred: Callable[["VirtualNet"], bool], max_cranks: int = 1_000_000
    ) -> None:
        n = 0
        while not pred(self):
            if self.crank() is None:
                raise CrankError("queue drained before predicate held")
            n += 1
            if n > max_cranks:
                raise CrankError(f"predicate not reached in {max_cranks} cranks")

    @property
    def quiescent(self) -> bool:
        """Nothing left to deliver: the live queue AND the shaper's
        held set are both empty (time-triggered adversaries check this,
        not ``queue`` alone — shaped traffic in flight is not silence)."""
        return not self.queue and not self._held

    def run_to_quiescence(self) -> None:
        while self.crank() is not None:
            pass

    def close_observers(self) -> None:
        """Close any per-node observers that hold resources (the flight
        recorder flushes and finalizes its journal here)."""
        for obs in self.observers.values():
            close = getattr(obs, "close", None)
            if close is not None:
                close()

    # -- internals ----------------------------------------------------------

    def _release_due(self) -> None:
        """Move shaped messages whose delivery time has arrived from the
        held set into the live queue, in (ready, enqueue-seq) order."""
        held = self._held
        while held and held[0][0] <= self.virtual_time:
            _ready, _seq, msg = heapq.heappop(held)
            self.queue.append(msg)

    def _process_step(self, node: Node, step: Step) -> None:
        node.outputs.extend(step.output)
        node.faults_observed.extend(step.fault_log)
        all_ids = self.node_ids()
        for tm in step.messages:
            for dest in tm.target.resolve(all_ids, node.node_id):
                msg = NetworkMessage(node.node_id, dest, tm.message)
                if node.is_faulty:
                    tampered = self.adversary.tamper(self, msg)
                    if tampered is None:
                        continue
                    msg = tampered
                # network-level adversary gate: censorship, eclipse and
                # crash-stop apply to EVERY message, not just faulty
                # senders' (the async model's network IS the adversary)
                filtered = self.adversary.filter_message(self, msg)
                if filtered is None:
                    self.adversary_filtered += 1
                    continue
                self._enqueue(filtered)

    def _enqueue(self, msg: NetworkMessage) -> None:
        """The simulator side of the shared shaping hook: consult the
        LinkShaper (if any) per directed edge; future-dated copies wait
        in the held set until the virtual clock reaches them."""
        if self.shaper is not None:
            from hbbft_tpu_torch.sim.trace import wire_size

            delays = self.shaper.shape_frame(
                msg.sender, msg.to, self.virtual_time,
                size_fn=lambda: wire_size(msg.payload))
            if delays is not None:
                for d in delays:
                    if d <= 0:
                        self.queue.append(msg)
                    else:
                        ready = self.virtual_time + d
                        self._held_seq += 1
                        heapq.heappush(
                            self._held,
                            (ready, self._held_seq,
                             NetworkMessage(msg.sender, msg.to,
                                            msg.payload, at=ready)))
                return
        self.queue.append(msg)


class NetBuilder:
    """Reference: ``tests/net/mod.rs :: NetBuilder``.

    ``using_step`` receives (node_id, netinfo_like) and returns the
    algorithm instance for that node.
    """

    def __init__(self, ids: Sequence[NodeId]):
        self.ids = list(ids)
        self._faulty: set = set()
        self._adversary: Optional[Adversary] = None
        self._message_limit: Optional[int] = None
        self._crank_limit: Optional[int] = None
        self._trace = None
        self._cost_model = None
        self._observer_factory: Optional[Callable[[NodeId], Any]] = None
        self._shaper = None

    def faulty(self, ids: Sequence[NodeId]) -> "NetBuilder":
        self._faulty = set(ids)
        return self

    def num_faulty(self, f: int) -> "NetBuilder":
        """Mark the first f ids faulty."""
        self._faulty = set(sorted(self.ids, key=repr)[:f])
        return self

    def adversary(self, adv: Adversary) -> "NetBuilder":
        self._adversary = adv
        return self

    def message_limit(self, n: int) -> "NetBuilder":
        self._message_limit = n
        return self

    def crank_limit(self, n: int) -> "NetBuilder":
        self._crank_limit = n
        return self

    def trace(self, log) -> "NetBuilder":
        """Attach an :class:`hbbft_tpu_torch.sim.trace.EventLog`."""
        self._trace = log
        return self

    def cost_model(self, model) -> "NetBuilder":
        """Attach an :class:`hbbft_tpu_torch.sim.trace.CostModel` (virtual clock)."""
        self._cost_model = model
        return self

    def shape(self, shape, seed: int = 0) -> "NetBuilder":
        """Attach link shaping — the simulator side of the shared hook
        (:mod:`hbbft_tpu_torch.chaos.link`).  ``shape`` is a ``NetShape`` (or a
        prebuilt ``LinkShaper``); times are in VIRTUAL seconds, so pair
        this with :meth:`cost_model` so the virtual clock advances (the
        net still progresses without one — an all-held queue jumps the
        clock to the next delivery — but latency numbers mean nothing)."""
        from hbbft_tpu_torch.chaos.link import LinkShaper

        self._shaper = (shape if isinstance(shape, LinkShaper)
                        else LinkShaper(shape, seed=seed))
        return self

    def observe(self, factory: Callable[[NodeId], Any]) -> "NetBuilder":
        """Attach one :class:`hbbft_tpu_torch.traits.StepObserver` per node —
        ``factory(node_id)`` builds it; the built observers are reachable
        as ``net.observers[node_id]``."""
        self._observer_factory = factory
        return self

    def flight(self, journal_root: str, **recorder_kwargs) -> "NetBuilder":
        """Attach a flight recorder per node: node ``i`` journals to
        ``<journal_root>/node-<i>`` with a **logical clock** (record
        sequence numbers), so the same deterministic schedule produces
        byte-identical journals.
        Call :meth:`VirtualNet.close_observers` when the run ends."""
        import os as _os

        from hbbft_tpu_torch.obs.flight import FlightObserver, FlightRecorder
        from hbbft_tpu_torch.obs.spans import SpanTracer

        def logical_clock():
            # per-node call counter: span timestamps must be as
            # deterministic as the journal's record clock
            state = [0.0]

            def clock() -> float:
                state[0] += 1.0
                return state[0]

            return clock

        def factory(nid: NodeId):
            rec = FlightRecorder(
                _os.path.join(journal_root, f"node-{nid}"),
                node=repr(nid), flavor="virtualnet", clock=None,
                **recorder_kwargs,
            )
            return FlightObserver(
                rec, spans=SpanTracer(node=nid, clock=logical_clock()))

        return self.observe(factory)

    def using_step(self, make_algo: Callable[[NodeId], Any]) -> VirtualNet:
        nodes = {
            nid: Node(
                node_id=nid,
                algorithm=make_algo(nid),
                is_faulty=nid in self._faulty,
            )
            for nid in self.ids
        }
        return VirtualNet(
            nodes,
            adversary=self._adversary,
            message_limit=self._message_limit,
            crank_limit=self._crank_limit,
            trace=self._trace,
            cost_model=self._cost_model,
            observers=(
                {nid: self._observer_factory(nid) for nid in self.ids}
                if self._observer_factory is not None else None
            ),
            shaper=self._shaper,
        )
