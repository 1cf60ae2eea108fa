"""``python -m hbbft_tpu_torch.obs.watch`` — the anomaly watchtower.

The live half of the health plane: one watchtower process polls every
node and gateway obs endpoint (``/status`` + ``/metrics`` + ``/health``)
*and* tails the cluster's flight journals through the streaming auditor
(:mod:`hbbft_tpu_torch.obs.audit_stream`), keeps bounded ring-buffer time
series, and turns the raw surfaces into **classified health incidents**:

- **forensic incidents** (streaming audit): a fork, a conflicting
  (sender, slot) value, a commit-monotonicity violation, or overload /
  spoof attribution raises an incident seconds after the evidence lands
  in a journal segment — deduplicated by ``(kind, subject)`` so one
  equivocating node is ONE incident no matter how many slots it poisons
  or how many poll ticks observe it;
- **SLO incidents** (rule engine): per-node epoch lag vs the cluster
  head (straggler score), mempool occupancy, pump/VID backlog pressure,
  degrade engagement, scrape reachability, cluster epochs/s floor and
  phase-p99 ceiling.  Rules carry **hysteresis** — a breach must hold
  for ``engage_ticks`` consecutive ticks to alarm and must clear for
  ``clear_ticks`` ticks to re-arm — so a flapping signal cannot
  alarm-storm.  Each engagement episode raises exactly one incident.
- **perf-drift incidents** (the performance sentinel): given a frozen
  same-host profile (``--perf-profile PATH``: mean seconds by pump
  segment, taken on the host being watched), every tick computes each node's live
  per-segment mean cost from the *delta* between consecutive
  ``/metrics`` scrapes (:func:`hbbft_tpu_torch.obs.perf.segment_means`) and
  compares it against the profile.  The worst live/profile mean ratio
  is the ``perf_drift_ratio`` signal; a built-in
  ``perf_drift_ratio<=perf_ratio`` rule rides the same hysteresis +
  episode machinery and raises ``perf_regression`` incidents — a hot
  path that got 2× slower alarms online, a noisy single window does
  not (segments below ``perf_min_events`` events per window are
  ignored).

SLO rule syntax (``--slo``, repeatable): ``signal<=limit`` or
``signal>=limit``, e.g. ``--slo "epochs_per_s>=0.5"`` (cluster floor),
``--slo "p99_s<=2.0"`` (cluster epoch-phase p99 ceiling, seconds),
``--slo "epoch_lag<=3"`` (per-node straggler ceiling), ``--slo
"mempool_frac<=0.9"``, ``--slo "pump_backlog_frac<=1.0"``, ``--slo
"vid_pending<=64"``.  Per-node rules evaluate once per target; cluster
rules once per tick.

Incidents are emitted as wire-registered
:class:`~hbbft_tpu_torch.obs.flight.HealthIncident` records into the
watchtower's own flight journal (``--journal-out``) — the online
detection trail is as durable and auditable as the evidence it points
at — and the aggregated cluster document is served on ``--serve-port``
as ``/health`` (the machine-readable headroom document the future
adaptive controller consumes).

Scrape fan-out is bounded: at most ``--scrape-workers`` concurrent
target polls, each with its own timeout, and a wedged or dead target
counts ``hbbft_health_scrape_failures_total{target}`` instead of
stalling the loop.

The core (:class:`Watchtower`) is clock-free by contract: ``tick(now,
snaps)`` takes the caller's clock and (optionally) pre-fetched
snapshots, so the chaos campaign drives it with virtual time and tests
drive it with a scripted clock; only the CLI loop reads wall clock.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque
from concurrent.futures import ThreadPoolExecutor, wait as _futures_wait
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from hbbft_tpu_torch.obs.audit_stream import (
    IncrementalAuditor,
    JournalTailer,
    extract_incidents,
)
from hbbft_tpu_torch.obs.http import http_get
from hbbft_tpu_torch.obs.metrics import (
    Registry, histogram_quantile, parse_prometheus_text,
)
from hbbft_tpu_torch.obs.perf import segment_means

Target = Tuple[str, int]

#: per-node SLO rules every watchtower runs even with no ``--slo`` flags
#: (conservative enough that a clean healthy cluster never alarms)
DEFAULT_SLOS = ("epoch_lag<=6", "mempool_frac<=0.95")

#: the phase whose cluster-summed histogram backs the ``p99_s`` signal
P99_PHASE = "epoch"


# ===========================================================================
# SLO rules
# ===========================================================================


@dataclass(frozen=True)
class SloRule:
    """One service-level rule: ``signal op limit``."""

    signal: str
    op: str              # "<=" (ceiling) | ">=" (floor)
    limit: float

    def breached(self, value: float) -> bool:
        return value > self.limit if self.op == "<=" \
            else value < self.limit

    @property
    def text(self) -> str:
        return f"{self.signal}{self.op}{self.limit:g}"


#: signals evaluated per target node (subject = the node); everything
#: else is cluster-scoped (subject = "cluster")
NODE_SIGNALS = frozenset({
    "epoch_lag", "mempool_frac", "pump_backlog_frac", "vid_pending",
    "degrade_active", "perf_drift_ratio",
})


def normalize_perf_profile(doc: Any) -> Dict[str, float]:
    """Accept either a frozen-profile document
    (``{"segments": {seg: {"mean_s": …}}}``) or
    a flat ``{segment: mean_s}`` mapping; return the flat form with
    non-positive baselines dropped (a zero baseline cannot anchor a
    ratio)."""
    segs = doc.get("segments", doc) if isinstance(doc, dict) else {}
    out: Dict[str, float] = {}
    for seg, v in segs.items():
        mean = v.get("mean_s") if isinstance(v, dict) else v
        try:
            mean = float(mean)
        # hblint: disable=fault-swallowed-drop (config parsing: a
        # malformed profile entry is skipped, not an ingress drop)
        except (TypeError, ValueError):
            continue
        if mean > 0:
            out[str(seg)] = mean
    return out


def parse_slo_rule(text: str) -> SloRule:
    """``"epochs_per_s>=0.5"`` → :class:`SloRule` (ValueError on any
    other shape — the two supported operators are the syntax)."""
    for op in ("<=", ">="):
        if op in text:
            signal, _, limit = text.partition(op)
            signal = signal.strip()
            if not signal:
                break
            try:
                return SloRule(signal, op, float(limit))
            # hblint: disable=fault-swallowed-drop (config parsing, not
            # an ingress path: the break falls through to the ValueError
            # below, so nothing is dropped — the caller gets the error)
            except ValueError:
                break
    raise ValueError(
        f"bad SLO rule {text!r}: expected signal<=limit or "
        f"signal>=limit")


# ===========================================================================
# Bounded time series
# ===========================================================================


class Ring:
    """Bounded (t, value) series with the derivations the rules need."""

    def __init__(self, maxlen: int = 64):
        self._buf: "deque[Tuple[float, float]]" = deque(maxlen=maxlen)

    def push(self, t: float, v: float) -> None:
        self._buf.append((t, v))

    @property
    def last(self) -> Optional[float]:
        return self._buf[-1][1] if self._buf else None

    def rate(self) -> Optional[float]:
        """Average per-second delta across the retained window (None
        until two samples exist or time stands still)."""
        if len(self._buf) < 2:
            return None
        (t0, v0), (t1, v1) = self._buf[0], self._buf[-1]
        if t1 <= t0:
            return None
        return (v1 - v0) / (t1 - t0)


# ===========================================================================
# Watchtower
# ===========================================================================


def poll_full(host: str, port: int,
              timeout_s: float = 2.0) -> Optional[dict]:
    """One target's ``{"status":…, "metrics":…, "health":…}`` snapshot,
    None if down.  ``health`` is None (not a failure) for endpoints
    predating the ``/health`` route (old nodes, gateways)."""
    try:
        status = json.loads(http_get(host, port, "/status", timeout_s))
        metrics = parse_prometheus_text(
            http_get(host, port, "/metrics", timeout_s))
    # hblint: disable=fault-swallowed-drop (accounted by the caller: a
    # None snapshot counts hbbft_health_scrape_failures_total{target}
    # and feeds the target_down hysteresis)
    except (OSError, ValueError):
        return None
    health: Optional[dict] = None
    try:
        health = json.loads(http_get(host, port, "/health", timeout_s))
    # hblint: disable=fault-swallowed-drop (benign: /health is optional
    # on old endpoints; the status/metrics surfaces above still feed
    # every signal that predates it)
    except (OSError, ValueError):
        health = None
    return {"status": status, "metrics": metrics, "health": health}


class Watchtower:
    """Bounded-state live health evaluation over a set of obs targets.

    Clock-free core: every public entry point takes ``now`` from the
    caller.  ``scrape()`` (the only I/O) is separable — ``tick(now,
    snaps=...)`` accepts pre-fetched snapshots so deterministic drivers
    (tests, the sim-cell campaign) never touch sockets.
    """

    def __init__(self, targets: List[Target],
                 gateways: Optional[List[Target]] = None, *,
                 journal_roots: Optional[List[str]] = None,
                 slos: Tuple[str, ...] = DEFAULT_SLOS,
                 engage_ticks: int = 2, clear_ticks: int = 2,
                 window: int = 64,
                 scrape_workers: int = 8, scrape_timeout_s: float = 2.0,
                 fetch: Optional[Callable[..., Optional[dict]]] = None,
                 recorder: Any = None,
                 registry: Optional[Registry] = None,
                 max_incidents: int = 4096,
                 max_read_bytes: int = 32 * 2**20,
                 derive_ticks: int = 1,
                 perf_profile: Optional[Dict[str, Any]] = None,
                 perf_ratio: float = 2.0,
                 perf_min_events: int = 20):
        self.targets = list(targets)
        self.gateways = list(gateways or [])
        self.rules = [parse_slo_rule(s) for s in slos]
        # the perf-drift sentinel: a frozen {segment: mean_s} baseline
        # arms a built-in per-node perf_drift_ratio ceiling rule that
        # rides the same hysteresis + episode machinery as every SLO
        self.perf_profile = (normalize_perf_profile(perf_profile)
                             if perf_profile else None)
        self.perf_ratio = float(perf_ratio)
        self.perf_min_events = max(1, int(perf_min_events))
        if self.perf_profile:
            self.rules.append(
                SloRule("perf_drift_ratio", "<=", self.perf_ratio))
        # previous scrape's pump-segment series per target (the drift
        # signal is a scrape-to-scrape delta, never the cumulative
        # totals — startup cost must not poison steady-state means);
        # bounded: one small filtered dict per target
        self._prev_segments: Dict[str, dict] = {}
        self.engage_ticks = max(1, engage_ticks)
        self.clear_ticks = max(1, clear_ticks)
        self.window = window
        self.scrape_timeout_s = scrape_timeout_s
        self.fetch = fetch if fetch is not None else poll_full
        self.recorder = recorder
        self.registry = registry if registry is not None else Registry()
        n_targets = len(self.targets) + len(self.gateways)
        # the scrape fan-out bound: a wedged target occupies one worker
        # for at most its socket timeout, and the tick only waits the
        # overall budget before counting stragglers as failures
        self._pool = ThreadPoolExecutor(
            max_workers=max(1, min(scrape_workers, max(1, n_targets))),
            thread_name_prefix="hbbft-watch")
        # forensic derivation cadence: polling (feeding new journal
        # bytes, itself bounded by max_read_bytes per segment read)
        # happens every tick, but the full AuditResult derivation +
        # incident extraction may be throttled to every Nth tick —
        # detection lag grows by at most (derive_ticks - 1) intervals,
        # a documented trade for riding along with a hot cluster
        self.derive_ticks = max(1, derive_ticks)
        self.tailer = (JournalTailer(journal_roots,
                                     IncrementalAuditor(max_events=0),
                                     max_read_bytes=max_read_bytes)
                       if journal_roots else None)
        # bounded per-(target, signal) series
        self._series: Dict[Tuple[str, str], Ring] = {}
        # rule hysteresis: (rule text, subject) → counters + episode
        self._rule_state: Dict[Tuple[str, str], Dict[str, int]] = {}
        # incident dedup across ticks: one (kind, subject) forever
        self._seen: "deque[Tuple[str, str]]" = deque(maxlen=max_incidents)
        self._seen_set: set = set()
        self.incidents: "deque[Dict[str, Any]]" = deque(
            maxlen=max_incidents)
        self.ticks = 0
        self._seq = 0
        r = self.registry
        self._c_ticks = r.counter(
            "hbbft_health_ticks_total", "watchtower poll ticks")
        self._c_scrapes = r.counter(
            "hbbft_health_scrapes_total",
            "target scrapes attempted (nodes + gateways)")
        self._c_scrape_fail = r.counter(
            "hbbft_health_scrape_failures_total",
            "target scrapes that failed or timed out, by target",
            labelnames=("target",), max_label_sets=n_targets + 1)
        self._c_incidents = r.counter(
            "hbbft_health_incidents_total",
            "health incidents raised, by classification kind",
            labelnames=("kind",), max_label_sets=32)
        self._g_targets_up = r.gauge(
            "hbbft_health_targets_up",
            "targets that answered the latest scrape")
        self._g_alerts = r.gauge(
            "hbbft_health_active_alerts",
            "SLO rules currently engaged (breach held past hysteresis)")

    # -- scraping (the only I/O in the class) --------------------------------

    def scrape(self) -> Dict[str, Optional[dict]]:
        """Poll every target once, bounded: concurrency-capped pool,
        per-target socket timeouts, and an overall wait budget — one
        wedged node can never stall the loop.  Failures are counted
        per target, never raised."""
        everyone = [("node", h, p) for h, p in self.targets] + \
                   [("gateway", h, p) for h, p in self.gateways]
        futures = {}
        for _kind, host, port in everyone:
            name = f"{host}:{port}"
            self._c_scrapes.inc()
            futures[self._pool.submit(
                self.fetch, host, port, self.scrape_timeout_s)] = name
        # bounded wait: each fetch bounds itself via socket timeouts;
        # the extra second covers scheduling, and anything still
        # running past it is this tick's failure (the worker frees
        # itself when its socket times out)
        _futures_wait(list(futures), timeout=self.scrape_timeout_s + 1.0)
        out: Dict[str, Optional[dict]] = {}
        for fut, name in futures.items():
            snap = None
            if fut.done():
                try:
                    snap = fut.result()
                # hblint: disable=fault-swallowed-drop (accounted just
                # below: the None snapshot counts the per-target
                # scrape-failure metric)
                except Exception:
                    snap = None
            else:
                fut.cancel()
            if snap is None:
                self._c_scrape_fail.labels(target=name).inc()
            out[name] = snap
        self._g_targets_up.set(
            sum(1 for s in out.values() if s is not None))
        return out

    # -- signal derivation ---------------------------------------------------

    def _ring(self, subject: str, signal: str) -> Ring:
        key = (subject, signal)
        ring = self._series.get(key)
        if ring is None:
            # bounded: one ring per (target, signal) pair — both finite
            ring = self._series[key] = Ring(self.window)
        return ring

    def _signals(self, now: float,
                 snaps: Dict[str, Optional[dict]]
                 ) -> Dict[Tuple[str, str], float]:
        """(signal, subject) → value for this tick, updating the ring
        buffers along the way."""
        values: Dict[Tuple[str, str], float] = {}
        node_names = [f"{h}:{p}" for h, p in self.targets]
        chain_lens: Dict[str, int] = {}
        for name in node_names:
            snap = snaps.get(name)
            if snap is None:
                continue
            st = snap.get("status") or {}
            chain_lens[name] = int(st.get("chain_len",
                                          st.get("batches", 0)))
        head = max(chain_lens.values(), default=0)
        for name in node_names:
            snap = snaps.get(name)
            if snap is None:
                continue
            st = snap.get("status") or {}
            hd = snap.get("health") or {}
            room = hd.get("headroom") or {}
            lag = head - chain_lens.get(name, 0)
            values[("epoch_lag", name)] = float(lag)
            mp = room.get("mempool") or {}
            if mp.get("cap"):
                values[("mempool_frac", name)] = float(mp.get("frac", 0))
            pb = room.get("pump_backlog") or {}
            if pb.get("cap"):
                values[("pump_backlog_frac", name)] = float(
                    pb.get("frac", 0))
            if "vid_pending" in room:
                values[("vid_pending", name)] = float(
                    room.get("vid_pending") or 0)
            values[("degrade_active", name)] = float(
                1 if (hd.get("degrade") or {}).get("active")
                or (st.get("degraded") or {}).get("active") else 0)
            drift = self._perf_drift(name, snap.get("metrics") or {})
            if drift is not None:
                values[("perf_drift_ratio", name)] = drift
            self._ring(name, "chain_len").push(
                now, float(chain_lens.get(name, 0)))
        # cluster signals
        self._ring("cluster", "head").push(now, float(head))
        rate = self._ring("cluster", "head").rate()
        if rate is not None:
            values[("epochs_per_s", "cluster")] = rate
        p99 = self._phase_p99(snaps)
        if p99 is not None:
            values[("p99_s", "cluster")] = p99
        return values

    def _phase_p99(self, snaps: Dict[str, Optional[dict]]
                   ) -> Optional[float]:
        """Cluster-summed p99 of the ``epoch`` phase histogram — the
        end-to-end latency ceiling signal."""
        by_le: Dict[float, float] = {}
        for snap in snaps.values():
            if snap is None:
                continue
            series = (snap.get("metrics") or {}).get(
                "hbbft_phase_duration_seconds_bucket") or []
            for labels, value in series:
                if labels.get("phase") != P99_PHASE:
                    continue
                le = float("inf") if labels.get("le") == "+Inf" \
                    else float(labels.get("le", "inf"))
                by_le[le] = by_le.get(le, 0.0) + value
        if not by_le:
            return None
        return histogram_quantile(sorted(by_le.items()), 0.99)

    def _perf_drift(self, name: str,
                    metrics: Dict[str, Any]) -> Optional[float]:
        """Worst live/profile per-segment mean-cost ratio for one node
        this tick, or None (no profile armed, first scrape of the
        target, or no profiled segment saw ``perf_min_events`` events
        since the last scrape).  Ratios come from scrape-to-scrape
        deltas so the signal tracks what the node is doing NOW."""
        if not self.perf_profile:
            return None
        keys = ("hbbft_pump_segment_seconds_sum",
                "hbbft_pump_segment_seconds_count")
        cur = {k: metrics.get(k, []) for k in keys}
        prev = self._prev_segments.get(name)
        self._prev_segments[name] = cur
        if prev is None:
            return None
        worst: Optional[float] = None
        for seg, live in segment_means(cur, prev).items():
            base = self.perf_profile.get(seg)
            if base is None or live["events"] < self.perf_min_events:
                continue
            ratio = live["mean_s"] / base
            if worst is None or ratio > worst:
                worst = ratio
        return worst

    # -- incident plumbing ---------------------------------------------------

    def _raise_incident(self, now: float, kind: str, severity: str,
                        subject: str, detail: str,
                        new: List[Dict[str, Any]],
                        dedup: Optional[Tuple[str, str]] = None) -> None:
        """Record one incident unless its dedup identity already fired.

        ``dedup`` defaults to ``(kind, subject)`` — the forensic
        incidents' contract: one equivocating node is one incident no
        matter how many slots or ticks carry the evidence.  Episodic
        SLO incidents pass an episode-scoped identity instead so a NEW
        engagement after a full clear can alarm again."""
        ident = dedup if dedup is not None else (kind, subject)
        if ident in self._seen_set:
            return
        if len(self._seen) == self._seen.maxlen:
            self._seen_set.discard(self._seen[0])
        self._seen.append(ident)
        self._seen_set.add(ident)
        self._seq += 1
        inc = {"seq": self._seq, "t": now, "kind": kind,
               "severity": severity, "subject": subject,
               "key": f"{ident[0]}:{ident[1]}", "detail": detail}
        self.incidents.append(inc)
        new.append(inc)
        self._c_incidents.labels(kind=kind).inc()
        if self.recorder is not None:
            self.recorder.record_incident(kind, severity, subject,
                                          inc["key"], detail, t=now)

    def _eval_rules(self, now: float,
                    values: Dict[Tuple[str, str], float],
                    snaps: Dict[str, Optional[dict]],
                    new: List[Dict[str, Any]]) -> None:
        """Hysteresis state machine over every (rule, subject) pair."""
        checks: List[Tuple[SloRule, str, float]] = []
        for rule in self.rules:
            if rule.signal in NODE_SIGNALS:
                for (sig, subject), v in values.items():
                    if sig == rule.signal:
                        checks.append((rule, subject, v))
            else:
                v = values.get((rule.signal, "cluster"))
                if v is not None:
                    checks.append((rule, "cluster", v))
        # target reachability rides the same hysteresis: a down target
        # breaches the implicit target_up rule
        down_rule = SloRule("target_up", ">=", 1.0)
        for name, snap in snaps.items():
            checks.append((down_rule, name,
                           0.0 if snap is None else 1.0))
        active = 0
        for rule, subject, value in checks:
            key = (rule.text, subject)
            st = self._rule_state.setdefault(
                key, {"breach": 0, "ok": 0, "active": 0, "episode": 0})
            if rule.breached(value):
                st["breach"] += 1
                st["ok"] = 0
                if not st["active"] and st["breach"] >= self.engage_ticks:
                    st["active"] = 1
                    st["episode"] += 1
                    kind = ("target_down"
                            if rule.signal == "target_up" else
                            "straggler" if rule.signal == "epoch_lag"
                            else "perf_regression"
                            if rule.signal == "perf_drift_ratio"
                            else f"slo_{rule.signal}")
                    self._raise_incident(
                        now, kind, "warn", subject,
                        f"{rule.text} breached: {rule.signal}="
                        f"{value:g} for {st['breach']} ticks",
                        new,
                        dedup=(f"{kind}:ep{st['episode']}", subject))
            else:
                st["ok"] += 1
                st["breach"] = 0
                if st["active"] and st["ok"] >= self.clear_ticks:
                    st["active"] = 0
            active += st["active"]
        self._g_alerts.set(active)

    # -- the tick ------------------------------------------------------------

    def tick(self, now: float,
             snaps: Optional[Dict[str, Optional[dict]]] = None
             ) -> List[Dict[str, Any]]:
        """One evaluation pass; returns the incidents raised THIS tick.

        ``snaps`` defaults to a live :meth:`scrape`; deterministic
        drivers pass their own."""
        if snaps is None:
            snaps = self.scrape()
        self.ticks += 1
        self._c_ticks.inc()
        new: List[Dict[str, Any]] = []
        # streaming forensics first: a fork outranks any SLO signal
        if self.tailer is not None:
            self.tailer.poll()
            if self.ticks % self.derive_ticks == 0 \
                    or self.derive_ticks == 1:
                for fi in extract_incidents(self.tailer.result()):
                    self._raise_incident(
                        now, fi["kind"], fi["severity"], fi["subject"],
                        fi["detail"], new)
        values = self._signals(now, snaps)
        self._eval_rules(now, values, snaps, new)
        self._last_values = values
        self._last_snaps_up = sum(
            1 for s in snaps.values() if s is not None)
        return new

    # -- the served document -------------------------------------------------

    def health_doc(self) -> Dict[str, Any]:
        """Aggregated machine-readable cluster health: verdict, active
        alerts, recent incidents, and the per-signal values the
        adaptive controller steers by."""
        values = getattr(self, "_last_values", {})
        active = [
            {"rule": key[0], "subject": key[1]}
            for key, st in sorted(self._rule_state.items())
            if st["active"]
        ]
        rank = {"ok": 0, "warn": 1, "fault": 2, "fork": 3}
        # warn is CURRENT state (engaged alerts clear when the breach
        # does); fault/fork are forensic evidence — permanent, a fork
        # does not un-happen when the signal recovers
        worst = "warn" if active else "ok"
        for inc in self.incidents:
            if (rank.get(inc["severity"], 0) >= rank["fault"]
                    and rank[inc["severity"]] > rank[worst]):
                worst = inc["severity"]
        return {
            "status": worst,
            "ticks": self.ticks,
            "targets": len(self.targets) + len(self.gateways),
            "targets_up": getattr(self, "_last_snaps_up", 0),
            "active_alerts": active,
            "signals": {
                f"{sig}@{subject}": round(v, 6)
                for (sig, subject), v in sorted(values.items())
            },
            "incidents": list(self.incidents)[-32:],
            "audit": (
                {"verdict": self.tailer.result().verdict,
                 "records": self.tailer.auditor.records_fed,
                 "torn_tails": self.tailer.auditor.torn_tails}
                if self.tailer is not None else None
            ),
        }

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        if self.recorder is not None:
            self.recorder.close()


# ===========================================================================
# CLI
# ===========================================================================


def _serve_health(watch: Watchtower, host: str, port: int):
    """Serve the watchtower's own ``/metrics`` + ``/health`` on a
    background thread (its own asyncio loop — the poll loop is
    synchronous)."""
    import asyncio
    import threading

    from hbbft_tpu_torch.obs.http import ObsServer

    started = threading.Event()
    box: Dict[str, Any] = {}

    def run() -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        server = ObsServer(watch.registry, health_fn=watch.health_doc)
        box["addr"] = loop.run_until_complete(server.start(host, port))
        started.set()
        loop.run_forever()

    t = threading.Thread(target=run, name="hbbft-watch-http",
                         daemon=True)
    t.start()
    started.wait(timeout=5.0)
    return box.get("addr")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.obs.watch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--targets", default="",
                    help="comma-separated host:port node obs endpoints")
    ap.add_argument("--base-port", type=int, default=0,
                    help="metrics base port (node i at base+i)")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--gateways", default="",
                    help="comma-separated host:port gateway endpoints")
    ap.add_argument("--journals", default="",
                    help="comma-separated journal roots to tail through "
                         "the streaming auditor")
    ap.add_argument("--slo", action="append", default=[],
                    metavar="RULE",
                    help="SLO rule (signal<=limit or signal>=limit); "
                         "repeatable; added to the defaults "
                         f"{', '.join(DEFAULT_SLOS)}")
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--iterations", type=int, default=0,
                    help="0 = run until interrupted")
    ap.add_argument("--engage-ticks", type=int, default=2)
    ap.add_argument("--clear-ticks", type=int, default=2)
    ap.add_argument("--scrape-workers", type=int, default=8)
    ap.add_argument("--scrape-timeout", type=float, default=2.0)
    ap.add_argument("--perf-profile", default="",
                    metavar="PATH",
                    help="frozen per-segment cost profile (JSON, "
                         "{\"segments\": {seg: {\"mean_s\": ...}}}, "
                         "taken on this host); arms the perf-drift "
                         "sentinel")
    ap.add_argument("--perf-ratio", type=float, default=2.0,
                    help="live/profile mean-cost ratio ceiling before "
                         "a perf_regression incident (default 2.0)")
    ap.add_argument("--journal-out", default="",
                    help="directory for the watchtower's own incident "
                         "journal (HealthIncident records)")
    ap.add_argument("--serve-port", type=int, default=0,
                    help="serve the aggregated /health (+ /metrics) "
                         "document on this port")
    ap.add_argument("--json", action="store_true",
                    help="print each tick's new incidents as JSONL")
    args = ap.parse_args(argv)

    from hbbft_tpu_torch.obs.top import parse_targets

    # journal-only mode is legitimate (tail + classify, nothing to
    # scrape): no targets required when --journals is given
    targets: List[Target] = []
    if args.targets or args.base_port:
        targets = parse_targets(args)
    elif not args.journals:
        raise SystemExit("need --targets, --base-port/--nodes, "
                         "or --journals")
    gw_targets: List[Target] = []
    for part in args.gateways.split(","):
        part = part.strip()
        if part:
            host, _, port = part.rpartition(":")
            gw_targets.append((host or "127.0.0.1", int(port)))
    roots = [p.strip() for p in args.journals.split(",") if p.strip()]
    recorder = None
    if args.journal_out:
        from hbbft_tpu_torch.obs.flight import FlightRecorder

        # hblint: disable=det-wall-clock (watchtower CLI: incident
        # timestamps are operator-facing wall clock by design)
        import time as _time

        recorder = FlightRecorder(args.journal_out, "watchtower",
                                  flavor="watch", clock=_time.time)
    profile = None
    if args.perf_profile:
        with open(args.perf_profile, encoding="utf-8") as fh:
            profile = json.load(fh)
    watch = Watchtower(
        targets, gw_targets, journal_roots=roots or None,
        slos=tuple(DEFAULT_SLOS) + tuple(args.slo),
        engage_ticks=args.engage_ticks, clear_ticks=args.clear_ticks,
        scrape_workers=args.scrape_workers,
        scrape_timeout_s=args.scrape_timeout,
        recorder=recorder,
        perf_profile=profile, perf_ratio=args.perf_ratio)
    if args.serve_port:
        addr = _serve_health(watch, "127.0.0.1", args.serve_port)
        print(f"watch: serving /health on {addr}", file=sys.stderr)

    import time

    i = 0
    try:
        while True:
            # hblint: disable=det-wall-clock (CLI poll loop: live
            # polling is wall-clock by nature; the Watchtower core
            # itself is clock-free — tick() takes the caller's clock)
            now = time.time()
            for inc in watch.tick(now):
                line = (json.dumps(inc, sort_keys=True) if args.json
                        else f"[{inc['severity']}] {inc['kind']} "
                             f"{inc['subject']}: {inc['detail']}")
                print(line, flush=True)
            i += 1
            if args.iterations and i >= args.iterations:
                break
            time.sleep(args.interval)
    # hblint: disable=fault-swallowed-drop (interactive exit, not a
    # dropped input: ^C ends the watch loop cleanly)
    except KeyboardInterrupt:
        pass
    doc = watch.health_doc()
    print(f"watch: {doc['status']} — {len(watch.incidents)} incidents "
          f"over {watch.ticks} ticks", file=sys.stderr)
    watch.close()
    return 0 if doc["status"] in ("ok", "warn") else 1


if __name__ == "__main__":
    sys.exit(main())
