"""Unified observability: metrics registry, epoch-phase spans, exposition.

The port's copy of the JAX package's ``obs/`` core (host code; nothing here
touches the card):

- :mod:`hbbft_tpu_torch.obs.metrics` — dependency-free labeled
  Counter/Gauge/Histogram registry with Prometheus-text and JSON exposition
  (naming convention ``hbbft_<layer>_<name>``);
- :mod:`hbbft_tpu_torch.obs.trace` — per-transaction causal trace ids and
  the ``FlightTrace`` journal record;
- :mod:`hbbft_tpu_torch.obs.spans` — the epoch-phase tracer protocols report
  into via the :class:`hbbft_tpu_torch.traits.StepObserver` hook: per-epoch
  spans for RBC Value/Echo/Ready, per-ABA-round BVal/Aux/Conf + coin,
  threshold-decrypt share/combine, and DKG rotation, exportable as JSONL;
- :mod:`hbbft_tpu_torch.obs.flight` — the black-box flight recorder: a
  bounded segment-rotated on-disk journal of protocol events (messages,
  commits with the ledger-digest chain, faults, spans, lifecycle notes),
  identical format from both ``VirtualNet`` and ``NodeRuntime``;
- :mod:`hbbft_tpu_torch.obs.http` — the asyncio ``/metrics``, ``/status``,
  ``/spans``, ``/flight`` endpoint every
  :class:`~hbbft_tpu_torch.net.runtime.NodeRuntime` serves;
- :mod:`hbbft_tpu_torch.obs.perf` — the performance plane: per-layer
  utilization and headroom from the pump's segment timers.

and the operator's tools over it:

- :mod:`hbbft_tpu_torch.obs.audit` (over :mod:`~hbbft_tpu_torch.obs.
  audit_stream`) — ``python -m hbbft_tpu_torch.obs.audit``, the cross-node
  forensic auditor: merged causal timeline, digest-chain agreement,
  first-divergent-epoch fork reports, equivocation evidence keyed to
  ``FaultKind``;
- :mod:`hbbft_tpu_torch.obs.critpath` — per-transaction critical paths
  from the journals, components summing exactly to each total;
- :mod:`hbbft_tpu_torch.obs.top` — a curses-free live cluster view;
- :mod:`hbbft_tpu_torch.obs.watch` — the anomaly watchtower: scrapes and
  journal tails through the streaming auditor, one incident an episode.
"""

from hbbft_tpu_torch.obs.flight import FlightObserver, FlightRecorder
from hbbft_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    histogram_quantile,
    parse_prometheus_text,
)
from hbbft_tpu_torch.obs.spans import Span, SpanTracer

__all__ = [
    "Counter",
    "FlightObserver",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "Registry",
    "Span",
    "SpanTracer",
    "histogram_quantile",
    "parse_prometheus_text",
]
