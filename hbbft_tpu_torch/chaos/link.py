"""Pluggable link shaping: seeded per-directed-edge fault policies.

The ONE place link faults are modeled (Thetacrypt evaluates threshold
services by sweeping exactly these network shapes — PAPERS.md):

- :class:`LinkPolicy` — the trait: given the link clock and a frame's
  size, decide whether the frame is delivered and with which per-copy
  delays.  Every random choice draws from the caller-supplied seeded RNG,
  so a (seed, schedule) pair replays byte-identically;
- :class:`ShapedLink` — the standard policy: latency + jitter, loss,
  duplication, reorder spread, a bandwidth cap (per-edge serialization
  queue), and timed partition windows that either *hold* frames until the
  heal (the transport default — models a healed path redelivering) or
  *drop* them outright;
- :class:`NetShape` — per-edge policy table with a default (edges are
  DIRECTED: ``(src, dst)``);
- :class:`LinkShaper` — the shared shaping hook both drivers consume:
  ``sim/virtual_net.py`` feeds it the virtual clock and enqueues shaped
  deliveries into its held queue; ``net/transport.py`` feeds it a
  monotonic-since-start clock and schedules shaped frames onto the event
  loop.  The shaper owns one seeded RNG and one mutable state dict per
  edge, and accounts every decision (``hbbft_chaos_*`` counters) — a
  dropped frame is never silent.

Time units are the *driver's clock units*: real seconds on the socket
path, virtual (cost-model) seconds in the simulator.  Presets are written
in real seconds; :meth:`NetShape.scaled` rescales a whole shape for the
simulator's much faster virtual clock (the campaign uses ``1e-3``).

The port's copy of the JAX package's module.  Its decisions are the
reference's, edge by edge, for the same seed, and its ``hbbft_chaos_*``
counters carry the reference's names on an
:mod:`hbbft_tpu_torch.obs.metrics` registry (``bind_registry`` re-homes
them onto a node's); :attr:`LinkShaper.counters` reads them by name.
"""

from __future__ import annotations

import hashlib
import random
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

NodeId = Hashable
Edge = Tuple[NodeId, NodeId]


class LinkPolicy:
    """Trait: one directed edge's shaping decision for one frame.

    Subclasses implement :meth:`decide`.  ``needs_size`` tells drivers
    whether the frame's byte size matters (the simulator only encodes a
    payload to measure it when a policy actually needs the number).
    """

    #: does decide() consult ``nbytes``? (bandwidth-capped links do)
    needs_size: bool = False

    def decide(self, now: float, nbytes: int, rng: random.Random,
               state: Dict[str, Any]) -> Tuple[bool, List[float]]:
        """``(deliver, delays)`` for one frame entering the link at
        ``now``: ``deliver`` False drops it; otherwise one copy is
        delivered per entry of ``delays`` (seconds after ``now``; more
        than one entry means duplication).  ``state`` is this edge's
        private mutable dict (e.g. the bandwidth queue tail)."""
        return True, [0.0]

    def scaled(self, k: float) -> "LinkPolicy":
        """This policy with every time constant multiplied by ``k``
        (identity for policies with no time constants)."""
        return self


@dataclass(frozen=True)
class ShapedLink(LinkPolicy):
    """The standard knob set — all times in the driver's clock units.

    ``partitions`` are half-open ``(start, end)`` windows on the link
    clock; during a window, ``partition_mode="hold"`` delivers the frame
    at the heal instant (the transport's at-least-once queue made
    visible), ``"drop"`` loses it outright (the simulator's hard-loss
    shape).
    """

    delay_s: float = 0.0
    jitter_s: float = 0.0
    loss: float = 0.0                 # P(drop) per frame
    dup: float = 0.0                  # P(second copy) per frame
    reorder: float = 0.0              # P(extra delay spread) per frame
    reorder_spread_s: float = 0.0
    bandwidth_bps: float = 0.0        # 0 = unlimited
    partitions: Tuple[Tuple[float, float], ...] = ()
    partition_mode: str = "hold"      # "hold" | "drop"

    @property
    def needs_size(self) -> bool:  # type: ignore[override]
        return self.bandwidth_bps > 0

    def decide(self, now: float, nbytes: int, rng: random.Random,
               state: Dict[str, Any]) -> Tuple[bool, List[float]]:
        for start, end in self.partitions:
            if start <= now < end:
                if self.partition_mode == "drop":
                    return False, []
                state["partition_holds"] = state.get(
                    "partition_holds", 0) + 1
                # delivered at the heal (plus the link's base latency)
                return True, [max(0.0, end - now) + self.delay_s]
        if self.loss > 0 and rng.random() < self.loss:
            return False, []
        d = self.delay_s
        if self.jitter_s > 0:
            d += rng.random() * self.jitter_s
        if self.reorder > 0 and rng.random() < self.reorder:
            d += rng.random() * self.reorder_spread_s
        if self.bandwidth_bps > 0 and nbytes > 0:
            # per-edge serialization queue: a frame transmits after the
            # previous one clears, at 8·nbytes/bps seconds per frame
            clear = max(now, state.get("bw_clear", 0.0))
            clear += 8.0 * nbytes / self.bandwidth_bps
            state["bw_clear"] = clear
            d += clear - now
        delays = [d]
        if self.dup > 0 and rng.random() < self.dup:
            # the copy lands nearby but not byte-simultaneously
            spread = self.jitter_s or self.delay_s or 0.001
            delays.append(d + rng.random() * spread)
        return True, delays

    def scaled(self, k: float) -> "ShapedLink":
        return replace(
            self,
            delay_s=self.delay_s * k,
            jitter_s=self.jitter_s * k,
            reorder_spread_s=self.reorder_spread_s * k,
            # time scaled by k ⇒ a frame's transmission time must scale
            # too: t' = k·8n/bps = 8n/(bps/k)
            bandwidth_bps=(self.bandwidth_bps / k
                           if self.bandwidth_bps > 0 else 0.0),
            partitions=tuple((s * k, e * k) for s, e in self.partitions),
        )


@dataclass
class NetShape:
    """Per-directed-edge policy table with an optional default."""

    default: Optional[LinkPolicy] = None
    edges: Dict[Edge, LinkPolicy] = field(default_factory=dict)

    def policy_for(self, src: NodeId, dst: NodeId) -> Optional[LinkPolicy]:
        return self.edges.get((src, dst), self.default)

    def scaled(self, k: float) -> "NetShape":
        return NetShape(
            default=self.default.scaled(k) if self.default else None,
            edges={e: p.scaled(k) for e, p in self.edges.items()},
        )


# ===========================================================================
# Presets (times in REAL seconds; .scaled(1e-3) for simulator cells)
# ===========================================================================


def _isolate(n: int, victim: int, policy: LinkPolicy,
             base: Optional[LinkPolicy] = None) -> NetShape:
    """``policy`` on every edge crossing the cut {victim} | rest."""
    edges: Dict[Edge, LinkPolicy] = {}
    for other in range(n):
        if other != victim:
            edges[(victim, other)] = policy
            edges[(other, victim)] = policy
    return NetShape(default=base, edges=edges)


def preset_shape(name: str, n: int) -> NetShape:
    """A named link-shaping preset for an ``n``-node cluster.

    The table (README "Chaos campaigns" has the prose version):

    ==============  ========================================================
    name            shape
    ==============  ========================================================
    none            no shaping (the control cell)
    wan-100ms       every link 50 ms ± 10 ms one-way (~100 ms RTT)
    lossy-1pct      every link drops 1% of frames, 5 ms ± 5 ms latency
    dup-reorder     5% duplication, 30% of frames re-spread over 50 ms
    partition-10s   node n−1 partitioned from everyone for t ∈ [2 s, 12 s),
                    frames held and delivered at the heal
    bandwidth-64k   every link capped at 64 kbit/s (serialization queue)
    bandwidth-asym  node n−1's links (both directions) capped at 64 KB/s,
                    every other link unshaped — the DispersedLedger WAN
                    shape: classic RBC collapses to the slow node's
                    uplink, VID keeps ordering at the fast nodes' pace
    ==============  ========================================================

    ``bandwidth-asym`` is deliberately NOT in :data:`PRESETS` (the full
    campaign grid): it exists for the targeted classic-vs-VID comparison
    cells and the ``BENCH_VID`` artifact, not for every adversary sweep.
    """
    if name in ("none", ""):
        return NetShape()
    if name == "wan-100ms":
        return NetShape(default=ShapedLink(delay_s=0.05, jitter_s=0.01))
    if name == "lossy-1pct":
        return NetShape(default=ShapedLink(delay_s=0.005, jitter_s=0.005,
                                           loss=0.01))
    if name == "dup-reorder":
        return NetShape(default=ShapedLink(delay_s=0.01, dup=0.05,
                                           reorder=0.3,
                                           reorder_spread_s=0.05))
    if name == "partition-10s":
        return _isolate(n, n - 1,
                        ShapedLink(delay_s=0.005,
                                   partitions=((2.0, 12.0),)),
                        base=ShapedLink(delay_s=0.005))
    if name == "bandwidth-64k":
        return NetShape(default=ShapedLink(delay_s=0.002,
                                           bandwidth_bps=64_000.0))
    if name == "bandwidth-asym":
        # one straggler at 64 KB/s (= 524288 bit/s) in BOTH directions,
        # everyone else unshaped — the shape under which payload-carrying
        # broadcast (classic RBC) serializes on the victim's uplink while
        # dispersal ships it only an O(1/n) shard
        return _isolate(n, n - 1,
                        ShapedLink(delay_s=0.002,
                                   bandwidth_bps=8.0 * 64 * 1024))
    raise ValueError(
        f"unknown chaos preset {name!r} "
        f"(known: {', '.join(PRESETS)}, bandwidth-asym)")


PRESETS: Tuple[str, ...] = ("none", "wan-100ms", "lossy-1pct",
                            "dup-reorder", "partition-10s",
                            "bandwidth-64k")


# ===========================================================================
# The shared shaping hook
# ===========================================================================


class LinkShaper:
    """Seeded per-edge shaping decisions + accounting for ONE driver.

    Clock-free by design: the driver supplies ``now`` on every call
    (virtual seconds in the simulator, monotonic-since-start seconds on
    the transport), so this module never reads a wall clock.

    Per-edge RNGs derive from ``(seed, src, dst)`` the same way the
    transport's :class:`~hbbft_tpu_torch.net.transport.BackoffPolicy` derives
    its streams, so one edge's draw count never perturbs another's.
    """

    def __init__(self, shape: NetShape, seed: int = 0, registry=None):
        self.shape = shape
        self.seed = seed
        self._rngs: Dict[Edge, random.Random] = {}
        self._state: Dict[Edge, Dict[str, Any]] = {}
        self._bind_metrics(registry)

    def _bind_metrics(self, registry) -> None:
        if registry is None:
            from hbbft_tpu_torch.obs.metrics import Registry

            registry = Registry()
        self.registry = registry
        r = registry
        self._c_shaped = r.counter(
            "hbbft_chaos_frames_shaped_total",
            "frames that passed through a link-shaping policy")
        self._c_dropped = r.counter(
            "hbbft_chaos_frames_dropped_total",
            "frames dropped by link shaping (loss or drop-mode "
            "partitions)")
        self._c_delayed = r.counter(
            "hbbft_chaos_frames_delayed_total",
            "frames delivered late by link shaping")
        self._c_dup = r.counter(
            "hbbft_chaos_frames_duplicated_total",
            "extra frame copies injected by link shaping")
        self._c_partition = r.counter(
            "hbbft_chaos_partition_holds_total",
            "frames held across a partition window until its heal")

    @property
    def counters(self) -> Dict[str, int]:
        """The shaping tallies by their metric names."""
        return {c.name: int(c.value()) for c in (
            self._c_shaped, self._c_dropped, self._c_delayed, self._c_dup,
            self._c_partition)}

    def bind_registry(self, registry) -> None:
        """Re-home the counters onto a node's registry (the transport
        calls this so shaping shows on that node's ``/metrics``)."""
        self._bind_metrics(registry)

    # -- decisions -----------------------------------------------------------

    def policy_for(self, src: NodeId, dst: NodeId) -> Optional[LinkPolicy]:
        return self.shape.policy_for(src, dst)

    def backlog_s(self, src: NodeId, dst: NodeId, now: float) -> float:
        """Seconds of bulk already committed to the ``src → dst`` edge's
        serialization queue (0.0 for unshaped / non-bandwidth edges).
        The transport consults this before pushing more best-effort bulk
        — e.g. VID dispersal shards beyond the cert's ``n − f`` voters —
        at a peer whose link is already the bottleneck."""
        state = self._state.get((src, dst))
        if not state:
            return 0.0
        return max(0.0, state.get("bw_clear", 0.0) - now)

    def rng_for(self, src: NodeId, dst: NodeId) -> random.Random:
        edge = (src, dst)
        rng = self._rngs.get(edge)
        if rng is None:
            digest = hashlib.sha3_256(
                b"hbbft-chaos-link:%d:%s>%s"
                % (self.seed, repr(src).encode(), repr(dst).encode())
            ).digest()
            rng = random.Random(int.from_bytes(digest[:8], "big"))
            self._rngs[edge] = rng
        return rng

    def shape_frame(self, src: NodeId, dst: NodeId, now: float,
                    nbytes: int = 0,
                    size_fn: Optional[Callable[[], int]] = None,
                    ) -> Optional[List[float]]:
        """Per-copy delivery delays for one frame on edge ``src → dst``.

        ``None`` means the edge has no policy (driver fast path — nothing
        counted); ``[]`` means the frame is dropped; otherwise deliver one
        copy per entry, that many units after ``now``.  ``size_fn`` is
        consulted only when the policy needs a size and ``nbytes`` is 0.
        """
        policy = self.shape.policy_for(src, dst)
        if policy is None:
            return None
        if policy.needs_size and nbytes == 0 and size_fn is not None:
            nbytes = size_fn()
        edge = (src, dst)
        state = self._state.setdefault(edge, {})
        holds_before = state.get("partition_holds", 0)
        deliver, delays = policy.decide(now, nbytes,
                                        self.rng_for(src, dst), state)
        self._c_shaped.inc()
        if not deliver:
            self._c_dropped.inc()
            return []
        if state.get("partition_holds", 0) > holds_before:
            self._c_partition.inc()
        if any(d > 0 for d in delays):
            self._c_delayed.inc()
        if len(delays) > 1:
            self._c_dup.inc(len(delays) - 1)
        return delays

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        return {
            "shaped": int(self._c_shaped.value()),
            "dropped": int(self._c_dropped.value()),
            "delayed": int(self._c_delayed.value()),
            "duplicated": int(self._c_dup.value()),
            "partition_holds": int(self._c_partition.value()),
        }
