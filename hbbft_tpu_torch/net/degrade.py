"""Guard-driven adaptive degradation + headroom-driven raising: the
bidirectional control ladder.

The overload-defense layer (transport ingress budgets, SenderQueue caps,
mempool shedding) is a set of hard ceilings: each engages only once its
buffer is already full, and each sheds by *eviction* — a cliff edge.
This module adds the graceful slope in front of those cliffs: a bounded
controller that watches the guard layer's own pressure counters and,
while pressure is sustained, shrinks what this node *volunteers* into
the system — its proposed batch size and its mempool admission ceilings
— then restores them once pressure clears.

Since the performance plane (:mod:`hbbft_tpu_torch.obs.perf`) the ladder also
extends *upward*: under sustained benign slack — guard
counters quiet, measured headroom above ``raise_headroom``, and real
demand present (a non-empty mempool; an idle node has nothing to absorb)
for ``raise_windows`` consecutive windows — the controller raises the
proposed batch size and mempool admission toward the measured MB-scale
optimum, one boost level at a time up to ``max_boost``.  The raise arm
is strictly subordinate: ANY abuse pressure instantly restores the exact
bases before the degradation ladder engages, sustained strain (demand
with headroom gone) steps the boost back down, and quiet windows (demand
gone) restore the exact configured bases — the raised state never
survives the load that justified it.

Design constraints:

- **Bounded and monotone-safe.**  The controller moves one level at a
  time through a fixed ladder (``max_level`` deep).  Every lever is a
  pure function of the level and the bases captured at attach time, so
  levels never compound and recovery restores the exact configured
  values.
- **Pressure is read from counters, not events.**  Each tick diffs the
  monotone guard ABUSE counters (decode strikes, strike-ladder
  disconnects) over the window — the controller needs no new plumbing
  into the hot paths and cannot miss events.  Rate-limit and capacity
  counters (ingress throttles, egress stalls, SenderQueue evictions)
  are deliberately NOT sources: they fire under honest open-loop
  saturation, which the mempool's fair-shedding layer owns.
- **Runs on the pump thread.**  :meth:`tick` is called between pump
  iterations (``StepPump`` wakes idle pumps every ``tick_s`` for exactly
  this reason — recovery must proceed while the node is quiet), so the
  batch-size mutation is serialized with the proposer that reads it.
- **Observable, never silent.**  Level transitions are counted
  (``hbbft_guard_degraded_transitions_total``, and
  ``hbbft_ctrl_transitions_total`` for the raise arm), the current state
  is exported as gauges (``hbbft_guard_degraded_level`` / ``_active`` /
  ``_batch_size``, plus ``hbbft_ctrl_boost_level`` /
  ``hbbft_ctrl_headroom``), journaled through the flight pipeline (note
  kind ``degrade`` — distinct from ``guard`` so the forensic auditor's
  overload attribution is not polluted by peerless controller events),
  and surfaced in ``/status``'s ``degraded`` section.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("hbbft_tpu_torch.net")


class DegradationController:
    """Bounded load-shedding ladder driven by guard pressure counters.

    ``sources`` is a list of ``(name, fn)`` pairs where ``fn() -> float``
    reads a monotone counter; the per-window pressure is the summed
    delta across all sources divided by the window length (events/s).
    Pressure at or above ``engage_per_s`` steps the level up;
    ``clear_windows`` consecutive windows below ``clear_per_s`` step it
    back down.  At level ``L`` the batch size and mempool ceilings are
    halved ``L`` times (floored at ``min_batch`` / ``min_capacity``).

    The raise arm (off unless ``max_boost > 0`` and a ``headroom_fn`` is
    wired): at level 0, ``raise_windows`` consecutive clean windows with
    ``demand_fn() > 0`` and ``headroom_fn() >= raise_headroom`` step
    ``boost`` up (levers doubled per boost level, capped at attach-time
    ceilings); ``clear_windows`` windows of strain (demand, no headroom)
    step it down; ``clear_windows`` windows of quiet (no demand) — or a
    single window of guard pressure — restore the exact bases at once.
    ``apply_level`` receives the SIGNED effective level
    (``level - boost``): positive degrades, negative raises, zero is the
    exact configured bases.
    """

    def __init__(
        self,
        *,
        sources: List,
        apply_level: Callable[[int], None],
        registry=None,
        window_s: float = 1.0,
        engage_per_s: float = 8.0,
        clear_per_s: float = 1.0,
        clear_windows: int = 3,
        max_level: int = 3,
        max_boost: int = 0,
        raise_windows: int = 10,
        raise_headroom: float = 0.6,
        headroom_fn: Optional[Callable[[], Optional[float]]] = None,
        demand_fn: Optional[Callable[[], float]] = None,
        on_transition: Optional[Callable[[int, int, str], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        from hbbft_tpu_torch.obs.metrics import Registry

        if window_s <= 0 or max_level < 1:
            raise ValueError("window_s must be > 0 and max_level >= 1")
        if max_boost < 0 or raise_windows < 1:
            raise ValueError("max_boost must be >= 0 and "
                             "raise_windows >= 1")
        self.sources = list(sources)
        self.apply_level = apply_level
        self.window_s = float(window_s)
        self.engage_per_s = float(engage_per_s)
        self.clear_per_s = float(clear_per_s)
        self.clear_windows = int(clear_windows)
        self.max_level = int(max_level)
        self.max_boost = int(max_boost)
        self.raise_windows = int(raise_windows)
        self.raise_headroom = float(raise_headroom)
        self.headroom_fn = headroom_fn
        self.demand_fn = demand_fn
        self.on_transition = on_transition
        self.clock = clock
        self.level = 0
        self.boost = 0
        self.last_pressure_per_s = 0.0
        self.last_headroom: Optional[float] = None
        self._clean = 0
        self._slack = 0
        self._strain = 0
        self._quiet = 0
        self._t_window = clock()
        self._last: Dict[str, float] = {
            name: float(fn()) for name, fn in self.sources
        }
        r = registry if registry is not None else Registry()
        self._g_level = r.gauge(
            "hbbft_guard_degraded_level",
            "current adaptive-degradation ladder level (0 = full "
            "service; each level halves proposed batch size and "
            "mempool admission ceilings)")
        self._g_active = r.gauge(
            "hbbft_guard_degraded_active",
            "1 while adaptive degradation is engaged (level > 0)")
        self._g_batch = r.gauge(
            "hbbft_guard_degraded_batch_size",
            "the batch size currently proposed under degradation "
            "(equals the configured base at level 0)")
        self._c_transitions = r.counter(
            "hbbft_guard_degraded_transitions_total",
            "adaptive-degradation level changes, by direction",
            labelnames=("direction",), max_label_sets=3)
        for d in ("up", "down"):
            self._c_transitions.labels(direction=d)
        self._g_boost = r.gauge(
            "hbbft_ctrl_boost_level",
            "current raise-arm boost level (0 = configured bases; each "
            "level doubles proposed batch size and mempool admission "
            "toward the attach-time ceilings)")
        self._g_headroom = r.gauge(
            "hbbft_ctrl_headroom",
            "latest headroom scalar the controller consumed from the "
            "perf plane (1 = idle, 0 = saturated; -1 = no sample yet)")
        self._c_ctrl_transitions = r.counter(
            "hbbft_ctrl_transitions_total",
            "raise-arm boost changes, by direction (`raise` under "
            "sustained slack, `lower` under strain, `restore` = exact "
            "bases on quiet or abuse preemption)",
            labelnames=("direction",), max_label_sets=4)
        for d in ("raise", "lower", "restore"):
            self._c_ctrl_transitions.labels(direction=d)
        self._g_level.set(0)
        self._g_active.set(0)
        self._g_boost.set(0)
        self._g_headroom.set(-1)

    # -- the ladder ----------------------------------------------------------

    @staticmethod
    def shrink(base: int, level: int, floor: int) -> int:
        """The lever law: halve ``base`` once per level, floored."""
        return max(int(floor), int(base) >> level)

    @staticmethod
    def grow(base: int, boost: int, ceiling: int) -> int:
        """The raise-arm lever law: double ``base`` once per boost
        level, capped at ``ceiling`` (the measured-optimum ceiling
        captured at attach time)."""
        return min(int(ceiling), int(base) << boost)

    def _pressure(self, dt: float) -> float:
        total = 0.0
        for name, fn in self.sources:
            now = float(fn())
            # a re-bound counter restarting at 0 must not read as a
            # negative delta and mask real pressure
            prev = self._last.get(name, 0.0)
            total += max(0.0, now - prev)
            self._last[name] = now
        return total / dt

    def _set_level(self, level: int, why: str) -> None:
        direction = "up" if level > self.level else "down"
        self.level = level
        self.apply_level(level - self.boost)
        self._g_level.set(level)
        self._g_active.set(1 if level else 0)
        self._c_transitions.labels(direction=direction).inc()
        if self.on_transition is not None:
            self.on_transition(level, self.batch_size(), why)
        logger.warning("degrade: level %d (%s, %s)", level, direction, why)

    def _set_boost(self, boost: int, direction: str, why: str) -> None:
        self.boost = boost
        self.apply_level(self.level - boost)
        self._g_boost.set(boost)
        self._c_ctrl_transitions.labels(direction=direction).inc()
        if self.on_transition is not None:
            self.on_transition(self.level - boost, self.batch_size(), why)
        logger.info("ctrl: boost %d (%s, %s)", boost, direction, why)

    def batch_size(self) -> int:
        """What the attach-time wiring reports as the current batch
        size lever value; overwritten by :func:`attach_runtime`."""
        return 0

    def tick(self) -> None:
        """One controller step (pump thread): no-op until a full window
        has elapsed, then judge the window's pressure."""
        now = self.clock()
        dt = now - self._t_window
        if dt < self.window_s:
            return
        self._t_window = now
        pressure = self._pressure(dt)
        self.last_pressure_per_s = pressure
        if pressure >= self.engage_per_s:
            self._clean = 0
            self._slack = 0
            if self.boost > 0:
                # abuse preempts any raised state BEFORE the degradation
                # ladder engages: one restore straight to the bases
                self._set_boost(0, "restore",
                                f"abuse pressure={pressure:.1f}/s")
            if self.level < self.max_level:
                self._set_level(self.level + 1,
                                f"pressure={pressure:.1f}/s")
        elif pressure <= self.clear_per_s:
            self._clean += 1
            if self.level > 0:
                if self._clean >= self.clear_windows:
                    self._clean = 0
                    self._set_level(
                        self.level - 1,
                        f"clean for {self.clear_windows} windows")
            else:
                self._raise_arm()
        else:
            # between the thresholds: hold the level, restart the
            # clean-window count (hysteresis — no up/down flapping)
            self._clean = 0
            self._slack = 0
            if self.boost > 0:
                # any guard pressure at all forfeits the raised state
                self._set_boost(0, "restore",
                                f"pressure={pressure:.1f}/s")

    def _raise_arm(self) -> None:
        """One clean level-0 window: judge slack / strain / quiet.

        Runs only when the degradation ladder is fully clear; disabled
        entirely (every counter pinned to 0) unless ``max_boost > 0``
        and a headroom source is wired — a controller without a perf
        plane behind it must never infer slack."""
        if self.max_boost <= 0 or self.headroom_fn is None:
            return
        headroom = self.headroom_fn()
        self.last_headroom = headroom
        self._g_headroom.set(-1 if headroom is None else headroom)
        demand = (float(self.demand_fn())
                  if self.demand_fn is not None else 0.0)
        if demand <= 0:
            self._slack = 0
            self._strain = 0
            self._quiet += 1
            if self._quiet >= self.clear_windows and self.boost > 0:
                self._quiet = 0
                self._set_boost(
                    0, "restore",
                    f"quiet for {self.clear_windows} windows")
            return
        self._quiet = 0
        if headroom is not None and headroom >= self.raise_headroom:
            self._strain = 0
            self._slack += 1
            if self._slack >= self.raise_windows \
                    and self.boost < self.max_boost:
                self._slack = 0
                self._set_boost(
                    self.boost + 1, "raise",
                    f"headroom={headroom:.2f} for "
                    f"{self.raise_windows} windows")
        else:
            self._slack = 0
            self._strain += 1
            if self._strain >= self.clear_windows and self.boost > 0:
                self._strain = 0
                self._set_boost(
                    self.boost - 1, "lower",
                    f"strain (headroom="
                    f"{'?' if headroom is None else f'{headroom:.2f}'})")

    def as_dict(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "boost": self.boost,
            "active": bool(self.level),
            "batch_size": self.batch_size(),
            "base_batch_size": getattr(self, "base_batch_size", None),
            "pressure_per_s": round(self.last_pressure_per_s, 3),
            "engage_per_s": self.engage_per_s,
            "max_level": self.max_level,
            "max_boost": self.max_boost,
            "headroom": self.last_headroom,
        }


def attach_runtime(runtime, *, min_batch: int = 8,
                   min_capacity: int = 64,
                   max_batch: Optional[int] = None,
                   max_capacity: Optional[int] = None,
                   **kwargs) -> Optional[DegradationController]:
    """Wire a :class:`DegradationController` onto a ``NodeRuntime``.

    Captures the configured bases (SenderQueue batch size, mempool
    capacity / pending-byte ceiling), binds the guard pressure sources,
    and returns the controller — or ``None`` when the wrapped protocol
    exposes no batch size to shrink (nothing to degrade).  Levers are
    applied between pump iterations, which serializes them with the
    proposer; the mempool attributes are read under its own lock on the
    admission path, so shrinking them mid-run is safe.

    The raise arm activates only when ``max_boost > 0`` is passed AND
    the runtime carries a perf plane (its measured headroom is the slack
    signal; mempool depth is the demand signal).  ``max_batch`` /
    ``max_capacity`` are the raise ceilings (default 8× the bases — the
    order of magnitude the MB-scale ingest sweeps measured as the
    throughput knee).
    """
    algo = runtime.sq.algo
    base_batch = getattr(algo, "batch_size", None)
    if base_batch is None:
        return None
    base_batch = int(base_batch)
    mp = runtime.mempool
    base_capacity = int(mp.capacity)
    base_pending = int(mp.max_pending_bytes)
    ceil_batch = int(max_batch) if max_batch is not None \
        else base_batch << 3
    ceil_capacity = int(max_capacity) if max_capacity is not None \
        else base_capacity << 3
    ceil_pending = base_pending << 3
    ingress = runtime.transport.ingress

    def apply_level(level: int) -> None:
        if level >= 0:
            algo.batch_size = DegradationController.shrink(
                base_batch, level, min_batch)
            mp.capacity = DegradationController.shrink(
                base_capacity, level, min_capacity)
            mp.max_pending_bytes = DegradationController.shrink(
                base_pending, level, 1)
        else:
            boost = -level
            algo.batch_size = DegradationController.grow(
                base_batch, boost, ceil_batch)
            mp.capacity = DegradationController.grow(
                base_capacity, boost, ceil_capacity)
            mp.max_pending_bytes = DegradationController.grow(
                base_pending, boost, ceil_pending)
        ctl._g_batch.set(algo.batch_size)

    def on_transition(level: int, batch: int, why: str) -> None:
        if runtime.flight is not None:
            # note kind "degrade", NOT "guard": these are peerless
            # controller events and must not enter the auditor's
            # per-peer overload attribution
            runtime.flight.on_note(
                "degrade",
                f"level={level} batch_size={batch} why={why!r}")

    # pressure sources are the guard's ABUSE verdicts only: decode
    # strikes (garbage streams) and strike-ladder disconnects
    # (sustained budget abuse).  Rate-limit and capacity counters —
    # ingress throttles, egress stalls, SenderQueue buffered-cap
    # evictions — all fire under honest saturation (an open-loop
    # loadgen, MB-scale ingestion backing up a lagging peer, a
    # bandwidth-shaped WAN link) and must not shrink service for
    # benign load; the mempool's fair-shedding layer owns that regime.
    sources = [
        ("ingress_disconnects", ingress._c_disconnects.total),
        ("decode_strikes", ingress._c_decode_strikes.total),
    ]
    # slack comes from the perf plane's MEASURED headroom — a runtime
    # without one (perf=None) never raises; demand is mempool depth (an
    # idle node has nothing to absorb, so quiet restores the bases)
    perf = getattr(runtime, "perf", None)
    kwargs.setdefault("headroom_fn",
                      perf.headroom if perf is not None else None)
    kwargs.setdefault("demand_fn", lambda: len(mp))
    ctl = DegradationController(
        sources=sources, apply_level=apply_level,
        registry=runtime.registry, on_transition=on_transition, **kwargs)
    ctl.batch_size = lambda: int(getattr(algo, "batch_size", 0))
    ctl.base_batch_size = base_batch
    ctl._g_batch.set(base_batch)
    return ctl
