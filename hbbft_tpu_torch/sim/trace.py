"""Structured observability for the simulators.

The reference's only tracing is ``log`` crate debug lines plus the
simulated-hardware timing table of ``examples/simulation.rs``.  This module
provides both, structured:

- :class:`EventLog` — one record per crank (sender, destination, message
  type, wire size, outputs and faults produced), queryable and summable;
- :class:`CostModel` — the reference example's synthetic hardware knobs
  (per-message CPU lag + size/bandwidth charge) driving a virtual clock, so
  throughput numbers mean something without real networking.

``VirtualNet`` takes both as optional constructor arguments; the batched
drivers of ``parallel/`` use :meth:`CostModel.batched_epoch_estimate`.

The port's copy of the JAX package's ``sim/trace.py``: the net-frame
tallies and the wire-size failure counter live on an
:mod:`hbbft_tpu_torch.obs.metrics` registry under the reference's names.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Any, Dict, Hashable, List, Optional, Tuple

logger = logging.getLogger("hbbft_tpu_torch.sim")


@dataclass
class CrankEvent:
    crank: int
    sender: Hashable
    dest: Hashable
    msg_type: str
    wire_bytes: int
    outputs: int
    faults: int
    virtual_time: float


@dataclass
class NetEvent:
    """One frame crossing the real transport (net/transport.py) — the
    socket-layer sibling of :class:`CrankEvent`.  ``direction`` is ``"send"``
    or ``"recv"`` from the recording node's perspective; ``kind`` is the
    frame-kind name (MSG/PING/TX/…); ``wire_bytes`` counts the framed size
    including the length prefix."""

    direction: str
    peer: Hashable
    kind: str
    wire_bytes: int
    t_mono: float


@dataclass
class EventLog:
    """Append-only per-crank event records with summary accessors.

    Net-frame counters live on an :mod:`hbbft_tpu_torch.obs.metrics` registry
    (``hbbft_sim_net_*``, labeled kind × direction) — the by-kind accessor
    methods are thin views over those counters, and attaching a node's
    registry (``registry=``) makes the log's tallies scrapeable alongside
    that node's other metrics.  The raw event lists are retained for
    detailed queries."""

    events: List[CrankEvent] = field(default_factory=list)
    net_events: List[NetEvent] = field(default_factory=list)
    registry: Optional[Any] = None

    def __post_init__(self):
        if self.registry is None:
            from hbbft_tpu_torch.obs.metrics import Registry

            self.registry = Registry()
        self._c_net_frames = self.registry.counter(
            "hbbft_sim_net_frames_total",
            "real-transport frames recorded by the event log",
            labelnames=("kind", "direction"),
        )
        self._c_net_bytes = self.registry.counter(
            "hbbft_sim_net_bytes_total",
            "framed bytes recorded by the event log",
            labelnames=("kind", "direction"),
        )

    def record(self, ev: CrankEvent) -> None:
        self.events.append(ev)
        logger.debug(
            "crank %d: %s→%s %s (%dB) outputs=%d faults=%d t=%.6f",
            ev.crank, ev.sender, ev.dest, ev.msg_type, ev.wire_bytes,
            ev.outputs, ev.faults, ev.virtual_time,
        )

    def record_net(self, ev: NetEvent) -> None:
        self.net_events.append(ev)
        self._c_net_frames.labels(kind=ev.kind,
                                  direction=ev.direction).inc()
        self._c_net_bytes.labels(kind=ev.kind,
                                 direction=ev.direction).inc(ev.wire_bytes)
        logger.debug(
            "net %s %s %s (%dB)", ev.direction, ev.peer, ev.kind,
            ev.wire_bytes,
        )

    def _sum_series(self, counter, direction: Optional[str] = None
                    ) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for labels, child in counter.series():
            if direction is not None and labels["direction"] != direction:
                continue
            k = labels["kind"]
            out[k] = out.get(k, 0) + int(child.get())
        return out

    def net_frames_by_kind(self) -> Dict[str, int]:
        return self._sum_series(self._c_net_frames)

    def net_bytes_by_kind(self) -> Dict[str, int]:
        return self._sum_series(self._c_net_bytes)

    def net_total_bytes(self, direction: Optional[str] = None) -> int:
        return sum(self._sum_series(self._c_net_bytes, direction).values())

    def messages_by_type(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.msg_type] = out.get(ev.msg_type, 0) + 1
        return out

    def bytes_by_type(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.msg_type] = out.get(ev.msg_type, 0) + ev.wire_bytes
        return out

    def total_bytes(self) -> int:
        return sum(ev.wire_bytes for ev in self.events)

    def __len__(self) -> int:
        return len(self.events)


@dataclass
class CostModel:
    """Reference ``examples/simulation.rs`` hardware model: delivering one
    message costs ``cpu_lag_s`` plus ``wire_bytes / bandwidth_bps``."""

    bandwidth_bps: float = 1e9
    cpu_lag_s: float = 1e-5
    # per-digest CPU charge for the proof-verification term of
    # batched_epoch_estimate (≈ one short SHA3-256 on a single core)
    hash_lag_s: float = 5e-7

    def charge(self, wire_bytes: int) -> float:
        return self.cpu_lag_s + 8.0 * wire_bytes / self.bandwidth_bps

    def batched_epoch_estimate(
        self, n: int, f: int, payload_bytes: int, aba_epochs: int
    ) -> float:
        """Virtual seconds for ONE bulk-synchronous HoneyBadger epoch.

        The batched simulator executes a whole communication round at once,
        so instead of per-crank charges it accrues the analytic PER-RECEIVER
        load (nodes receive in parallel; the epoch's virtual duration is one
        node's sequential receive work under this hardware model).  Counts
        per receiver, with N RBC instances and shard size B ≈ payload/k:

        - Value: N shards+proofs (one per instance addressed to us);
        - Echo: N instances × N sources, shard+proof each;
        - Ready: N × N digests;
        - per ABA epoch: N instances × N sources × 3 votes (BVal+Aux+Conf),
          charged at 8 framed bytes per vote (1 payload byte + wire/header
          overhead), and on coin epochs N×N 96-byte G2 shares — the coin
          term charges at least one coin epoch even when aba_epochs < 3,
          covering the schedule's mandatory first threshold-coin flip;
        - Merkle proof VERIFICATION compute: (depth+1) digests for each of
          the N×N received echo proofs (plus N Values).  The large-N
          full-delivery path replaces per-receiver proof checks with a
          god-view commitment comparison (parallel/rbc.py::_run_large), so
          the work a deployment would do is charged HERE rather than
          silently dropped.
        """
        k = max(n - 2 * f, 1)
        shard = max(2, -(-(4 + payload_bytes) // k))
        depth = max(1, (n - 1).bit_length())
        proof = 32 * (depth + 1) + 16
        value_b = n * (shard + proof)
        echo_b = n * n * (shard + proof)
        ready_b = n * n * 40
        votes_b = aba_epochs * n * n * 3 * 8
        coin_b = max(aba_epochs // 3, 1) * n * n * 96
        msgs = (
            n + 2 * n * n + aba_epochs * n * n * 3
            + max(aba_epochs // 3, 1) * n * n
        )
        total_b = value_b + echo_b + ready_b + votes_b + coin_b
        verify_digests = (n * n + n) * (depth + 1)
        return (
            msgs * self.cpu_lag_s
            + 8.0 * total_b / self.bandwidth_bps
            + verify_digests * self.hash_lag_s
        )


_wire_size_failed_types: set = set()


def wire_size(payload: Any) -> int:
    """Canonical wire size of a protocol message.

    An encode failure still returns 0 (the crank loop must not die on an
    unencodable adversarial payload), but it is no longer silent: every
    failure increments ``hbbft_sim_wire_size_failures_total`` (labeled by
    the nested type path, on the process-wide default registry) and the
    offending type path is logged once — so EventLog byte totals can't
    under-report without leaving a trace."""
    import struct

    from hbbft_tpu_torch.protocols import wire

    try:
        return len(wire.encode_message(payload))
    except (TypeError, ValueError, struct.error) as exc:
        from hbbft_tpu_torch.obs.metrics import DEFAULT

        path = msg_type_path(payload)
        DEFAULT.counter(
            "hbbft_sim_wire_size_failures_total",
            "messages whose wire size could not be computed "
            "(byte totals under-report by these)",
            labelnames=("type",),
        ).labels(type=path).inc()
        if path not in _wire_size_failed_types:
            _wire_size_failed_types.add(path)
            logger.warning(
                "wire_size: cannot encode %s (%s) — counting as 0 bytes; "
                "EventLog byte totals under-report this type", path, exc,
            )
        return 0


def msg_type_path(payload: Any) -> str:
    """Type path through nested wrappers, e.g.
    ``HbWrap/SubsetWrap/BroadcastWrap/EchoMsg`` — the outermost name alone
    would put every DHB message in one uninformative bucket."""
    parts = []
    seen = 0
    while payload is not None and seen < 8:
        parts.append(type(payload).__name__)
        payload = getattr(payload, "msg", None)
        seen += 1
    return "/".join(parts)
