"""The observability core, host side: the port against the JAX package.

The same operations go to ``obs/metrics.py``'s ``Registry``, ``obs/trace.py``
and ``obs/perf.py``'s ``PerfPlane`` in both packages: the Prometheus and
JSON expositions, the fault counter, ``trace_id``, packed trace ids and the
``FlightTrace`` record's wire bytes, and the perf plane's windows, summary,
``/perf`` document and journaled snapshots on a scripted clock.  The
moved-onto-the-registry counters of ``sim/trace.py`` (the event log's
net-frame tallies, the wire-size failures) and ``chaos/link.py``'s
``LinkShaper`` (re-homed by ``bind_registry``) expose the same metrics.
Tolerance: exact, byte for byte.
"""

import importlib
import json
import time

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def exercise_registry(pkg):
    metrics = m(pkg, "obs.metrics")
    fault_log = m(pkg, "fault_log")
    reg = metrics.Registry()
    c = reg.counter("hbbft_test_frames_total", "frames by kind",
                    labelnames=("kind", "direction"))
    c.labels(kind="MSG", direction="send").inc()
    c.labels(kind="MSG", direction="send").inc(4)
    c.labels(kind="PING", direction="recv").inc(0.5)
    plain = reg.counter("hbbft_test_plain_total", "no labels")
    plain.inc(7)
    g = reg.gauge("hbbft_test_depth", "a gauge", labelnames=("peer",))
    g.labels(peer="3").set(12.25)
    g.labels(peer='q"uote\\').set(-1)
    h = reg.histogram("hbbft_test_latency_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1, 1.0))
    for v in (0.0005, 0.002, 0.05, 0.05, 0.5, 3.0):
        h.observe(v)
    hl = reg.histogram("hbbft_test_seg_seconds", "per segment",
                       labelnames=("segment",), buckets=(1e-4, 1e-2))
    hl.labels(segment="msg").observe(0.001)
    hl.labels(segment="flush").observe(0.5)
    state = {"n": 0}

    def refresh():
        state["n"] += 1
        reg.gauge("hbbft_test_refreshes", "scrapes seen").set(state["n"])

    reg.register_callback(refresh)
    faults = metrics.fault_counter(reg)
    faults.labels(kind=fault_log.FaultKind.MultipleDecryptionShares.name).inc()
    # a second registration of the same name returns the same family
    assert reg.counter("hbbft_test_plain_total", "no labels") is plain
    with pytest.raises(ValueError):
        reg.counter("not a name!")
    with pytest.raises(ValueError):
        reg.gauge("hbbft_test_plain_total")  # another kind, same name
    text = reg.render_prometheus()
    return (text, reg.render_json(), json.dumps(reg.as_dict(), sort_keys=True),
            sorted(reg.names()), h.quantile(0.5), h.quantile(0.99),
            metrics.parse_prometheus_text(text))


def test_registry_exposition_matches_reference():
    assert exercise_registry(PKGS[1]) == exercise_registry(PKGS[0])


def test_histogram_quantile_matches_reference():
    cum = [(0.001, 1), (0.01, 3), (0.1, 7), (1.0, 9), (float("inf"), 10)]
    got = [m(p, "obs.metrics").histogram_quantile(cum, q) for p in PKGS
           for q in (0.0, 0.1, 0.5, 0.9, 0.95, 1.0)]
    assert got[:6] == got[6:]


def trace_case(pkg):
    tr = m(pkg, "obs.trace")
    wire = m(pkg, "protocols.wire")
    txs = [b"", b"tx-1", bytes(range(250)), b"\xff" * 4096]
    tids = [tr.trace_id(tx) for tx in txs]
    packed = tr.pack_tids(tids)
    rec = tr.FlightTrace(seq=3, t=12.5, stage="commit", era=1, epoch=7, hop=3,
                         detail="client-0", tids=packed)
    data = wire.encode_message(rec)
    back = wire.decode_message(data)
    assert back == rec and hash(back) == hash(rec)
    ctx = tr.TraceContext(tids[1], 0).next().next()
    return (tids, packed, tr.iter_tids(packed), data, dict(tr.STAGE_HOPS),
            tr.tid_of_digest(bytes(range(32))), (ctx.tid, ctx.hop))


def test_trace_ids_and_flight_trace_bytes_match_reference():
    assert trace_case(PKGS[1]) == trace_case(PKGS[0])


def perf_case(pkg, monkeypatch):
    metrics = m(pkg, "obs.metrics")
    perf = m(pkg, "obs.perf")
    cpu = [0.0]
    monkeypatch.setattr(time, "process_time", lambda: cpu[0])
    reg = metrics.Registry()
    seg = reg.histogram("hbbft_pump_segment_seconds", "", labelnames=("segment",))
    ph = reg.histogram("hbbft_phase_duration_seconds", "", labelnames=("phase",))
    ers = reg.counter("hbbft_rbc_erasure_bytes_total", "", labelnames=("backend",))
    sent = reg.counter("hbbft_net_bytes_sent_total", "")
    pump = {"cpu": 0.0, "it": 0, "off": 0}
    recorded = []
    plane = perf.PerfPlane(
        reg, 0, interval_s=1.0, ring=4, snapshot_every=2,
        pump_cpu_fn=lambda: pump["cpu"],
        pump_stats_fn=lambda: (pump["it"], pump["off"]),
        record=lambda **kw: recorded.append(json.dumps(kw, sort_keys=True)))
    windows = [plane.maybe_sample(10.0)]
    for k in range(1, 8):
        for _ in range(10 * k):
            seg.labels(segment="msg").observe(0.002 * k)
        seg.labels(segment="deferred").observe(0.01 * k)
        seg.labels(segment="recv").observe(0.003)
        seg.labels(segment="flush").observe(0.001 * k)
        ph.labels(phase="decrypt_share").observe(0.05)
        ph.labels(phase="aba_coin").observe(0.02 * k)
        ers.labels(backend="device").inc(1e6 * k)
        sent.inc(5e4)
        cpu[0] += 0.25 * k
        pump["cpu"] += 0.1 * k
        pump["it"] += 7
        pump["off"] += k
        windows.append(plane.maybe_sample(10.0 + k))
        windows.append(plane.maybe_sample(10.0 + k + 0.5))  # rate-limited
    doc = plane.perf_doc()
    parsed = metrics.parse_prometheus_text(reg.render_prometheus())
    return (json.dumps(windows, sort_keys=True), json.dumps(doc, sort_keys=True),
            json.dumps(plane.summary(), sort_keys=True), plane.headroom(),
            plane.utilization(), recorded, reg.render_prometheus(),
            json.dumps(perf.segment_means(parsed), sort_keys=True))


def test_perf_plane_snapshots_match_reference(monkeypatch):
    ref = perf_case(PKGS[0], monkeypatch)
    assert perf_case(PKGS[1], monkeypatch) == ref
    assert ref[5]  # some windows were journaled


def test_sim_and_chaos_counters_live_on_the_registry():
    """``EventLog`` tallies, the wire-size failure counter and the link
    shaper's counters are registry metrics under the reference's names."""
    out = []
    for pkg in PKGS:
        metrics = m(pkg, "obs.metrics")
        sim = m(pkg, "sim.trace")
        link = m(pkg, "chaos.link")
        reg = metrics.Registry()
        log = sim.EventLog(registry=reg)
        for i, (d, kind, nb) in enumerate([("send", "MSG", 40), ("recv", "MSG", 52),
                                           ("send", "PING", 9)]):
            log.record_net(sim.NetEvent(d, i % 2, kind, nb, float(i)))
        shaper = link.LinkShaper(link.NetShape(default=link.ShapedLink(
            dup=1.0, delay_s=0.01, partitions=((1.0, 2.0),))), seed=2)
        shaper.shape_frame(0, 1, 0.0)
        shaper.bind_registry(reg)  # a node's registry: counts start there
        shaper.shape_frame(0, 1, 1.5)
        shaper.shape_frame(1, 0, 3.0)
        out.append((reg.render_prometheus(), shaper.stats()))
    assert out[0] == out[1]
    port_link = m(PKGS[1], "chaos.link")
    shaper = port_link.LinkShaper(port_link.NetShape(
        default=port_link.ShapedLink(delay_s=0.01)), seed=0)
    shaper.shape_frame(0, 1, 0.0)
    assert shaper.counters["hbbft_chaos_frames_shaped_total"] == 1
    port_sim = m(PKGS[1], "sim.trace")
    port_dhb = m(PKGS[1], "protocols.dynamic_honey_badger")
    default = m(PKGS[1], "obs.metrics").DEFAULT

    def failures():
        fam = default.get("hbbft_sim_wire_size_failures_total")
        return 0 if fam is None else fam.value(type="HbWrap/int")

    before = failures()
    assert port_sim.wire_size(port_dhb.HbWrap(0, 5)) == 0
    assert failures() == before + 1
