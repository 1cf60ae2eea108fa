"""Performance plane: continuous profiling + online headroom model.

The observability stack sees faults (health plane) and latency structure
(causal tracing) but was blind to *capacity*: where CPU goes, how much
slack each layer has, and whether a change silently regressed a hot
path.  :class:`PerfPlane` is the always-on answer, built to cost almost
nothing on the hot path:

- **Sampling by counter snapshot, not by instrumentation.**  The pump
  already attributes its wall time per work segment into the
  ``hbbft_pump_segment_seconds`` histogram and its CPU time per
  iteration into the scheduler's ``cpu_seconds`` accumulator; the span
  tracer already attributes consensus wall time per phase.  The sampler
  reads those cumulative sums once per ``interval_s`` (a dozen float
  reads — no locks, no syscalls beyond two clock reads) and folds the
  *deltas* into bounded ring time-series.  Nothing new runs per message.
- **Clock-free core.**  Every derivation takes ``now`` from the caller;
  the ONE wall-clock read lives in :meth:`PerfPlane.maybe_sample`, the
  sampler entry point.
- **Headroom model.**  Per-layer utilization — ``recv`` (ingress
  decode), ``pump`` (protocol state machine), ``crypto`` (threshold
  pairing phases), ``erasure`` (RS/Merkle throughput vs. a calibrated
  reference rate), ``egress`` (coalesced flush) — each a busy-seconds /
  wall-seconds fraction over the window, plus the whole-process CPU
  fraction.  ``headroom = 1 - max(utilization)``: the single scalar the
  bidirectional degradation controller consumes as its slack signal
  (raise batch size only when headroom is real, not inferred).
- **Flame doc + flight journal.**  ``/perf`` serves
  :meth:`PerfPlane.perf_doc` — a flame-style layer→segment tree over the
  retained window plus the raw ring series; every ``snapshot_every``-th
  sample is journaled as a wire-registered ``PerfSnapshot`` flight
  record so the perf history rides the same black box as faults.

Overhead model: one sample per ``interval_s`` touches a few dozen Python
floats and allocates one small dict.  The plane's cost on the card's host
is not measured yet.
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

#: pump segments that are protocol/state-machine work (the pump layer);
#: ``recv`` and ``flush`` are broken out as their own layers and
#: ``queue_wait`` is latency, not busy time (excluded from utilization)
PUMP_SEGMENTS = ("msg", "input", "hello", "startup", "guard", "shed",
                 "deferred")

#: span phases folded into the crypto layer: threshold-decrypt share
#: verification/combination and the common coin are the pairing-heavy
#: phases (span wall time is a proxy for crypto busy time — spans
#: overlap under pipelining, so this can exceed 1.0; it is clamped)
CRYPTO_PHASES = ("decrypt_share", "decrypt_combine", "aba_coin")

#: reference RS/Merkle throughput used to convert erasure bytes/s into a
#: utilization fraction: the JAX package's default, kept so both packages
#: compute the same headroom.  It is no rate measured on a card or for
#: the port's erasure backends; override per deployment via
#: ``erasure_ref_mbps``
DEFAULT_ERASURE_REF_MBPS = 300.0

ALL_LAYERS = ("recv", "pump", "crypto", "erasure", "egress")


class PerfPlane:
    """Always-on sampling profiler + headroom model for one node.

    ``registry`` is the node's metric registry (segment/phase histograms
    and byte counters are read from it); ``pump_cpu_fn`` returns the
    scheduler's cumulative pump CPU seconds and ``pump_stats_fn`` its
    ``(iterations, offloaded)`` counters; ``record`` (optional) journals
    a dict snapshot (the runtime wires ``FlightRecorder.record_perf``).
    """

    def __init__(self, registry: Any, node_id: Any, *,
                 interval_s: float = 1.0, ring: int = 240,
                 snapshot_every: int = 10,
                 erasure_ref_mbps: float = DEFAULT_ERASURE_REF_MBPS,
                 pump_cpu_fn: Optional[Callable[[], float]] = None,
                 pump_stats_fn: Optional[
                     Callable[[], Tuple[int, int]]] = None,
                 record: Optional[Callable[..., Any]] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.registry = registry
        self.node_id = node_id
        self.interval_s = float(interval_s)
        self.snapshot_every = max(1, int(snapshot_every))
        self.erasure_ref_mbps = float(erasure_ref_mbps)
        self.pump_cpu_fn = pump_cpu_fn
        self.pump_stats_fn = pump_stats_fn
        self.record = record
        #: bounded window ring — the whole retained perf history
        self.windows: Deque[Dict[str, Any]] = deque(maxlen=int(ring))
        self.samples = 0
        self._last_t: Optional[float] = None
        self._prev: Optional[Dict[str, float]] = None
        # the model's own exposition: latest headroom / per-layer
        # utilization as gauges (scrapeable without /perf) and a sample
        # counter so an operator can tell a stalled sampler from an
        # idle node
        self._g_headroom = registry.gauge(
            "hbbft_perf_headroom",
            "latest measured headroom (1 = idle, 0 = saturated; -1 "
            "until the sampler's first complete window)")
        self._g_util = registry.gauge(
            "hbbft_perf_util",
            "latest per-layer utilization fraction over the sampling "
            "window (recv/pump/crypto/erasure/egress busy seconds per "
            "wall second; cpu = whole-process CPU fraction)",
            labelnames=("layer",), max_label_sets=len(ALL_LAYERS) + 2)
        self._c_samples = registry.counter(
            "hbbft_perf_samples_total",
            "completed perf-plane sampling windows")
        self._g_headroom.set(-1)
        for layer in ALL_LAYERS + ("cpu",):
            self._g_util.labels(layer=layer)

    # -- the one wall-clock entry point ---------------------------------------

    def maybe_sample(self, now: Optional[float] = None) -> Optional[dict]:
        """Rate-limited sampler: called from the pump tick (so it never
        races an iteration); samples at most once per ``interval_s``.
        The only wall-clock read in the module lives here — everything
        below takes ``now`` from its caller."""
        if now is None:
            # hblint: disable=det-wall-clock (the sampler entry point:
            # the perf plane measures REAL elapsed time by contract;
            # sim/test callers pass their own `now`)
            now = time.monotonic()
        if self._last_t is not None and now - self._last_t < self.interval_s:
            return None
        return self.sample(now)

    # -- clock-free core ------------------------------------------------------

    def _snapshot_counters(self) -> Dict[str, float]:
        """One flat read of every cumulative source the model consumes."""
        snap: Dict[str, float] = {}
        seg_h = self.registry.get("hbbft_pump_segment_seconds")
        if seg_h is not None:
            for seg in PUMP_SEGMENTS + ("recv", "flush"):
                child = seg_h.labels(segment=seg)
                snap[f"seg:{seg}:sum"] = child.sum
                snap[f"seg:{seg}:count"] = float(child.count)
        ph_h = self.registry.get("hbbft_phase_duration_seconds")
        if ph_h is not None:
            for ph in CRYPTO_PHASES:
                child = ph_h.labels(phase=ph)
                snap[f"phase:{ph}:sum"] = child.sum
        ers = self.registry.get("hbbft_rbc_erasure_bytes_total")
        snap["erasure_bytes"] = ers.total() if ers is not None else 0.0
        sent = self.registry.get("hbbft_net_bytes_sent_total")
        snap["sent_bytes"] = sent.value() if sent is not None else 0.0
        snap["proc_cpu"] = time.process_time()
        if self.pump_cpu_fn is not None:
            snap["pump_cpu"] = float(self.pump_cpu_fn())
        if self.pump_stats_fn is not None:
            it, off = self.pump_stats_fn()
            snap["pump_iters"] = float(it)
            snap["pump_offloaded"] = float(off)
        return snap

    def sample(self, now: float) -> Optional[dict]:
        """Fold one window: deltas of every cumulative source since the
        previous sample → per-segment busy fractions, per-layer
        utilization, and the headroom scalar.  Returns the window dict
        (also appended to the bounded ring), or None on the priming
        sample (no previous snapshot to delta against)."""
        snap = self._snapshot_counters()
        prev, self._prev = self._prev, snap
        last_t, self._last_t = self._last_t, now
        if prev is None or last_t is None:
            return None
        dt = now - last_t
        if dt <= 0:
            return None

        def delta(key: str) -> float:
            return max(0.0, snap.get(key, 0.0) - prev.get(key, 0.0))

        segments: Dict[str, Dict[str, float]] = {}
        for seg in PUMP_SEGMENTS + ("recv", "flush"):
            busy = delta(f"seg:{seg}:sum")
            events = delta(f"seg:{seg}:count")
            if events <= 0 and busy <= 0:
                continue
            segments[seg] = {
                "busy_s": busy,
                "events": int(events),
                "mean_s": (busy / events) if events > 0 else 0.0,
                "frac": min(1.0, busy / dt),
            }

        def seg_busy(names) -> float:
            return sum(segments.get(s, {}).get("busy_s", 0.0)
                       for s in names)

        crypto_busy = sum(delta(f"phase:{p}:sum") for p in CRYPTO_PHASES)
        erasure_bps = delta("erasure_bytes") / dt
        layers = {
            "recv": min(1.0, seg_busy(("recv",)) / dt),
            "pump": min(1.0, seg_busy(PUMP_SEGMENTS) / dt),
            "crypto": min(1.0, crypto_busy / dt),
            "erasure": min(1.0, erasure_bps
                           / (self.erasure_ref_mbps * 1e6)),
            "egress": min(1.0, seg_busy(("flush",)) / dt),
        }
        cpu_frac = min(1.0, delta("proc_cpu") / dt)
        pump_cpu_frac = (min(1.0, delta("pump_cpu") / dt)
                         if "pump_cpu" in snap else None)
        util = max(max(layers.values()), cpu_frac)
        window = {
            "t": now,
            "wall_s": dt,
            "cpu_frac": cpu_frac,
            "pump_cpu_frac": pump_cpu_frac,
            "layers": layers,
            "segments": segments,
            "headroom": max(0.0, 1.0 - util),
        }
        if "pump_iters" in snap:
            iters = delta("pump_iters")
            window["pump_iters"] = int(iters)
            window["offload_frac"] = (
                delta("pump_offloaded") / iters if iters > 0 else 0.0)
        self.windows.append(window)
        self.samples += 1
        self._c_samples.inc()
        self._g_headroom.set(window["headroom"])
        for layer, frac in layers.items():
            self._g_util.labels(layer=layer).set(frac)
        self._g_util.labels(layer="cpu").set(cpu_frac)
        if self.record is not None and (
                self.samples % self.snapshot_every == 0):
            self.record(window_s=dt, cpu_frac=cpu_frac,
                        headroom=window["headroom"],
                        doc=json.dumps({"layers": layers,
                                        "segments": segments},
                                       sort_keys=True))
        return window

    # -- derived views --------------------------------------------------------

    def headroom(self) -> Optional[float]:
        """Latest headroom scalar (1 = idle, 0 = saturated), or None
        before the first complete window — callers (the controller's
        slack input) must treat None as "no evidence of slack"."""
        if not self.windows:
            return None
        return self.windows[-1]["headroom"]

    def utilization(self) -> Dict[str, float]:
        """Latest per-layer utilization ({} before the first window)."""
        if not self.windows:
            return {}
        return dict(self.windows[-1]["layers"])

    def summary(self) -> Dict[str, Any]:
        """Compact dict for ``/status`` (`status_doc()['perf']`)."""
        if not self.windows:
            return {"samples": self.samples, "headroom": None, "util": {}}
        w = self.windows[-1]
        return {
            "samples": self.samples,
            "headroom": w["headroom"],
            "util": {k: round(v, 4) for k, v in w["layers"].items()},
            "cpu_frac": round(w["cpu_frac"], 4),
        }

    def perf_doc(self) -> Dict[str, Any]:
        """The ``/perf`` document: a flame-style layer→segment tree of
        busy seconds aggregated over the retained ring, plus the raw
        window series (newest last) for time-axis consumers."""
        agg_seg: Dict[str, float] = {}
        agg_layer: Dict[str, float] = {k: 0.0 for k in ALL_LAYERS}
        wall = 0.0
        for w in self.windows:
            wall += w["wall_s"]
            for seg, s in w["segments"].items():
                agg_seg[seg] = agg_seg.get(seg, 0.0) + s["busy_s"]
            for layer, frac in w["layers"].items():
                agg_layer[layer] += frac * w["wall_s"]

        def seg_children(names) -> List[dict]:
            return [{"name": s, "value": round(agg_seg[s], 6)}
                    for s in names if agg_seg.get(s, 0.0) > 0.0]

        layer_segs = {"recv": ("recv",), "pump": PUMP_SEGMENTS,
                      "egress": ("flush",)}
        flame = {
            "name": f"node{self.node_id}",
            "value": round(wall, 6),
            "children": [
                {"name": layer,
                 "value": round(agg_layer[layer], 6),
                 "children": seg_children(layer_segs.get(layer, ()))}
                for layer in ALL_LAYERS
            ],
        }
        return {
            "node": self.node_id,
            "interval_s": self.interval_s,
            "samples": self.samples,
            "windows": len(self.windows),
            "headroom": self.headroom(),
            "util": self.utilization(),
            "flame": flame,
            "series": list(self.windows),
        }


def segment_means(metrics: Dict[str, Any],
                  prev: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Per-segment ``{mean_s, busy_s, events}`` from a parsed
    ``/metrics`` exposition (``parse_prometheus_text`` output) —
    optionally as a delta against an earlier scrape of the same node.
    This is the shared read path of the watchtower's perf-drift sentinel
    and ``bench.py``'s pump-utilization lines / frozen profiles."""

    def fold(parsed, suffix):
        out: Dict[str, float] = {}
        for labels, v in parsed.get(
                f"hbbft_pump_segment_seconds_{suffix}", []):
            seg = labels.get("segment")
            if seg is not None:
                out[seg] = out.get(seg, 0.0) + v
        return out

    sums, counts = fold(metrics, "sum"), fold(metrics, "count")
    if prev is not None:
        psums, pcounts = fold(prev, "sum"), fold(prev, "count")
        sums = {s: v - psums.get(s, 0.0) for s, v in sums.items()}
        counts = {s: v - pcounts.get(s, 0.0) for s, v in counts.items()}
    out: Dict[str, Dict[str, float]] = {}
    for seg, n in counts.items():
        if n <= 0:
            continue
        busy = max(0.0, sums.get(seg, 0.0))
        out[seg] = {"mean_s": busy / n, "busy_s": busy, "events": n}
    return out
