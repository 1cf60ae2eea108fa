"""Dependency-free labeled metrics registry with Prometheus/JSON exposition.

One :class:`Registry` per node (a :class:`~hbbft_tpu_torch.net.runtime.NodeRuntime`
owns one; standalone pieces create private ones) holds
:class:`Counter`/:class:`Gauge`/:class:`Histogram` metrics, each optionally
labeled.  Exposition is Prometheus text format 0.0.4 (``render_prometheus``)
or JSON (``as_dict``) — no client library, no threads, no globals beyond the
module-level :data:`DEFAULT` registry used by process-wide simulator
counters.

Invariants the registry enforces (tier-1 tested):

- metric names must be valid Prometheus identifiers; registration is
  get-or-create and re-registering with a different kind/labelnames raises;
- label cardinality is capped per metric (``max_label_sets``): overflowing
  label sets collapse into a single ``"_overflow_"`` series (and are counted
  in ``Registry.dropped_label_sets``) instead of growing without bound under
  e.g. Byzantine peers inventing ids;
- histogram buckets must be strictly increasing; the ``+Inf`` bucket is
  implicit;
- HELP text and label values are escaped per the Prometheus text rules
  (``\\``, ``\n``, and ``"`` in label values).

Naming convention (checked by ``tools_check_metrics.py``):
``hbbft_<layer>_<name>`` with layer one of ``net`` (transport), ``node``
(runtime/consensus), ``phase`` (epoch-phase tracer), ``sim`` (simulators).
"""

from __future__ import annotations

import json
import math
import re
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

OVERFLOW = "_overflow_"

# default histogram buckets: ms-to-seconds scale, matching consensus phase
# latencies on a localhost cluster through to multi-second large-N epochs
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def escape_label_value(text: str) -> str:
    return (
        text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Child:
    """One labeled series of a metric."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount

    def set(self, v: float) -> None:
        self.value = float(v)

    def get(self) -> float:
        return self.value


class _HistChild:
    __slots__ = ("counts", "sum", "count", "_buckets")

    def __init__(self, buckets: Sequence[float]):
        self._buckets = buckets
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, b in enumerate(self._buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[Tuple[float, int]]:
        """[(le, cumulative_count)] including +Inf."""
        out = []
        acc = 0
        for b, c in zip(self._buckets, self.counts):
            acc += c
            out.append((b, acc))
        out.append((math.inf, acc + self.counts[-1]))
        return out

    def quantile(self, q: float) -> float:
        return histogram_quantile(self.cumulative(), q)


class Metric:
    """Base: a named family of labeled series."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 registry: Optional["Registry"] = None,
                 max_label_sets: int = 256):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.max_label_sets = max_label_sets
        self.registry = registry
        self._children: Dict[Tuple[str, ...], Any] = {}
        if not self.labelnames:
            # an unlabeled metric always exposes its (zero) sample — a
            # scraper must be able to distinguish "0 so far" from "metric
            # doesn't exist" (labeled metrics expose series as labels
            # appear, or via explicit pre-init like fault_counter)
            self._child(())

    def _new_child(self):
        return _Child()

    def _child(self, labelvalues: Tuple[str, ...]):
        child = self._children.get(labelvalues)
        if child is None:
            if (len(self._children) >= self.max_label_sets
                    and labelvalues != (OVERFLOW,) * len(self.labelnames)):
                # cardinality cap: collapse into the overflow series
                if self.registry is not None:
                    self.registry.dropped_label_sets += 1
                return self._child((OVERFLOW,) * len(self.labelnames))
            child = self._new_child()
            self._children[labelvalues] = child
        return child

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass labels positionally or by name")
            values = tuple(str(kv[ln]) for ln in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {values}"
            )
        return self._child(values)

    def series(self) -> List[Tuple[Dict[str, str], Any]]:
        return [
            (dict(zip(self.labelnames, lv)), child)
            for lv, child in sorted(self._children.items())
        ]

    # -- unlabeled conveniences ---------------------------------------------

    def _default(self):
        return self._child(())


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def set(self, v: float) -> None:
        """Internal view support (attribute-API shims); not for new code."""
        self._default().set(v)

    def value(self, **kv) -> float:
        if kv:
            return self.labels(**kv).get()
        return self._default().get()

    def total(self) -> float:
        return sum(c.get() for c in self._children.values())


class Gauge(Metric):
    kind = "gauge"

    def set(self, v: float) -> None:
        self._default().set(v)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().inc(-amount)

    def value(self, **kv) -> float:
        if kv:
            return self.labels(**kv).get()
        return self._default().get()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str, labelnames: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional["Registry"] = None,
                 max_label_sets: int = 256):
        buckets = tuple(float(b) for b in buckets)
        if not buckets:
            raise ValueError("histogram needs at least one bucket")
        for lo, hi in zip(buckets, buckets[1:]):
            if not lo < hi:
                raise ValueError(
                    f"histogram buckets must be strictly increasing: "
                    f"{lo!r} !< {hi!r}"
                )
        if buckets[-1] == math.inf:
            buckets = buckets[:-1]  # +Inf is implicit
        self.buckets = buckets
        super().__init__(name, help, labelnames, registry=registry,
                         max_label_sets=max_label_sets)

    def _new_child(self):
        return _HistChild(self.buckets)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)


class Registry:
    """A set of metrics with shared exposition.

    ``counter``/``gauge``/``histogram`` are get-or-create: registering the
    same name again returns the existing metric (so independent components
    can share a series), but a kind or labelnames mismatch raises — two
    subsystems silently disagreeing about a metric is a bug.
    """

    def __init__(self):
        self._metrics: "Dict[str, Metric]" = {}
        self._callbacks: List[Callable[[], None]] = []
        self._lock = threading.Lock()
        self.dropped_label_sets = 0

    # -- registration --------------------------------------------------------

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if existing.kind != cls.kind or (
                    existing.labelnames != tuple(labelnames)
                ):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind}{existing.labelnames}, requested "
                        f"{cls.kind}{tuple(labelnames)}"
                    )
                want = kw.get("buckets")
                if want is not None and tuple(
                    b for b in (float(x) for x in want) if b != math.inf
                ) != existing.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {existing.buckets}, requested "
                        f"{tuple(want)}"
                    )
                return existing
            metric = cls(name, help, labelnames, registry=self, **kw)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = (), **kw) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames, **kw)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = (), **kw) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames, **kw)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  **kw) -> Histogram:
        return self._get_or_create(Histogram, name, help, labelnames,
                                   buckets=buckets, **kw)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def register_callback(self, fn: Callable[[], None]) -> None:
        """``fn`` runs before every exposition — the hook for gauges whose
        value is derived state (queue depths, peer epochs) rather than
        incrementally maintained."""
        self._callbacks.append(fn)

    def collect(self) -> List[Metric]:
        for fn in self._callbacks:
            fn()
        return [self._metrics[n] for n in sorted(self._metrics)]

    # -- exposition ----------------------------------------------------------

    def render_prometheus(self) -> str:
        out: List[str] = []
        for m in self.collect():
            out.append(f"# HELP {m.name} {escape_help(m.help)}")
            out.append(f"# TYPE {m.name} {m.kind}")
            for labels, child in m.series():
                base = _render_labels(labels)
                if m.kind == "histogram":
                    for le, cum in child.cumulative():
                        ls = _render_labels(dict(labels, le=_fmt(le)))
                        out.append(f"{m.name}_bucket{ls} {cum}")
                    out.append(f"{m.name}_sum{base} {_fmt(child.sum)}")
                    out.append(f"{m.name}_count{base} {child.count}")
                else:
                    out.append(f"{m.name}{base} {_fmt(child.get())}")
        out.append("")
        return "\n".join(out)

    def as_dict(self) -> Dict[str, Any]:
        doc: Dict[str, Any] = {}
        for m in self.collect():
            series = []
            for labels, child in m.series():
                if m.kind == "histogram":
                    series.append({
                        "labels": labels,
                        "sum": child.sum,
                        "count": child.count,
                        "buckets": [
                            [("+Inf" if le == math.inf else le), cum]
                            for le, cum in child.cumulative()
                        ],
                    })
                else:
                    series.append({"labels": labels, "value": child.get()})
            doc[m.name] = {"type": m.kind, "help": m.help, "series": series}
        return doc

    def render_json(self) -> str:
        return json.dumps(self.as_dict())


def _render_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{escape_label_value(str(v))}"' for k, v in labels.items()
    )
    return "{" + inner + "}"


class MetricAttr:
    """Descriptor: a numeric attribute view over an unlabeled metric held
    on the instance (``backing`` names the instance attribute storing the
    metric).  This is the shim that keeps pre-registry attribute APIs —
    ``stats.frames_sent += 1`` — working while the registry carries the
    series, without a hand-written property pair per field."""

    def __init__(self, backing: str, cast=int):
        self.backing = backing
        self.cast = cast

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return self.cast(getattr(obj, self.backing).value())

    def __set__(self, obj, v) -> None:
        getattr(obj, self.backing).set(v)


# -- shared helpers ----------------------------------------------------------


def fault_counter(registry: Registry) -> Counter:
    """The per-FaultKind Byzantine-evidence counter, with every variant
    pre-initialized to 0 so exposition always shows the complete label set
    (``tools_check_metrics.py`` asserts this coverage)."""
    from hbbft_tpu_torch.fault_log import FaultKind

    c = registry.counter(
        "hbbft_node_faults_total",
        "Byzantine faults observed, by FaultKind variant",
        labelnames=("kind",),
        max_label_sets=len(FaultKind) + 1,
    )
    for k in FaultKind:
        c.labels(kind=k.name)
    return c


def histogram_quantile(cumulative: Iterable[Tuple[float, float]],
                       q: float) -> float:
    """Prometheus-style quantile estimate from cumulative ``(le, count)``
    pairs (last pair is the ``+Inf`` bucket): linear interpolation within
    the bucket containing the target rank; the +Inf bucket reports its
    lower bound."""
    pairs = sorted(cumulative)
    if not pairs:
        return math.nan
    total = pairs[-1][1]
    if total <= 0:
        return math.nan
    rank = q * total
    prev_le, prev_cum = 0.0, 0.0
    for le, cum in pairs:
        if cum >= rank:
            if le == math.inf:
                return prev_le
            if cum == prev_cum:
                return le
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = le, cum
    return prev_le


def parse_prometheus_text(
    text: str,
) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Parse exposition text back into ``{name: [(labels, value)]}`` —
    enough for ``obs.top`` and for round-trip tests; histogram series
    appear under their ``_bucket``/``_sum``/``_count`` names."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})?\s+(\S+)$",
                     line)
        if not m:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, _g, labelstr, valstr = m.groups()
        labels: Dict[str, str] = {}
        if labelstr:
            for lm in re.finditer(
                r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"', labelstr
            ):
                # unescape left-to-right in one pass: sequential
                # .replace() calls corrupt values like 'C:\\new' (the
                # unescaped backslash joins the following 'n')
                labels[lm.group(1)] = re.sub(
                    r"\\(.)",
                    lambda m: {"n": "\n"}.get(m.group(1), m.group(1)),
                    lm.group(2),
                )
        if valstr == "+Inf":
            value = math.inf
        elif valstr == "-Inf":
            value = -math.inf
        else:
            value = float(valstr)
        out.setdefault(name, []).append((labels, value))
    return out


#: process-wide default registry — used only by components with no natural
#: owner (the simulator-side wire_size failure counter); everything tied to
#: a node goes on that node's own registry
DEFAULT = Registry()
