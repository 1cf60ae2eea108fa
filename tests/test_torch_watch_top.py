"""The live view, ``obs.watch`` and ``obs.top``: the port against the JAX
package on scripted scrapes.

Both packages' watchtowers are driven tick by tick with the same scripted
``/status`` + ``/metrics`` + ``/health`` snapshots (no sockets): SLO rule
parsing, the bounded ring, straggler hysteresis (a one-tick flap raises
nothing, a held breach one incident, a new episode after a full clear one
more), a dead target, a cluster-scoped floor, and the performance sentinel
armed from a synthetic frozen profile (a held 3x slowdown of one node's
``msg`` segment raises one ``perf_regression`` an episode; windows of too few
events and an unarmed tower raise nothing).  Each gives the same incidents
and the same ``/health`` document.  ``obs.top`` renders one fixed snapshot
of two nodes and a gateway to the same text table and the same ``--json``
document.  Tolerance: exact.
"""

import importlib
import json

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def targets(n=4):
    return [("127.0.0.1", 9000 + i) for i in range(n)]


def names(n=4):
    return [f"127.0.0.1:{9000 + i}" for i in range(n)]


def snap(chain_len, mempool_frac=0.1):
    return {"status": {"chain_len": chain_len}, "metrics": {},
            "health": {"status": "ok",
                       "headroom": {"mempool": {"used": 1, "cap": 10,
                                                "frac": mempool_frac}}}}


def test_slo_rule_parsing_matches_reference():
    got = {}
    for pkg in PKGS:
        w = m(pkg, "obs.watch")
        rules = [w.parse_slo_rule(t) for t in ("epoch_lag<=6", "epochs_per_s>=0.5")]
        bad = []
        for text in ("nope", "x==1", "<=3", "lag<=abc"):
            with pytest.raises(ValueError) as err:
                w.parse_slo_rule(text)
            bad.append(str(err.value))
        got[pkg] = ([(r.signal, r.op, r.limit, r.text, r.breached(7.0), r.breached(0.4))
                     for r in rules], bad, w.DEFAULT_SLOS)
    assert got[PKGS[1]] == got[PKGS[0]]


def test_ring_is_bounded_like_reference():
    got = {}
    for pkg in PKGS:
        ring = m(pkg, "obs.watch").Ring(maxlen=4)
        seen = [(ring.last, ring.rate())]
        for i in range(10):
            ring.push(float(i), float(2 * i))
            seen.append((ring.last, ring.rate(), len(ring._buf)))
        got[pkg] = seen
    assert got[PKGS[1]] == got[PKGS[0]]
    assert got[PKGS[1]][-1] == (18.0, pytest.approx(2.0), 4)


def drive(pkg, script, **kw):
    """One watchtower of ``pkg`` over the scripted ticks; returns every
    tick's new incidents and the final ``/health`` document."""
    tower = m(pkg, "obs.watch").Watchtower(targets(kw.pop("n", 4)), **kw)
    try:
        raised = [tower.tick(float(t), snaps=s) for t, s in enumerate(script)]
        return raised, tower.health_doc()
    finally:
        tower.close()


def straggler_script():
    def snaps(lagging):
        out = {n: snap(20) for n in names()}
        if lagging:
            out[names()[3]] = snap(4)
        return out
    return [snaps(x) for x in [True, False] + [True] * 5 + [False] * 3 + [True] * 4]


def test_straggler_hysteresis_matches_reference():
    got = {pkg: drive(pkg, straggler_script(), engage_ticks=2, clear_ticks=2) for pkg in PKGS}
    assert json.dumps(got[PKGS[1]], sort_keys=True) == json.dumps(got[PKGS[0]], sort_keys=True)
    raised = [i for tick in got[PKGS[1]][0] for i in tick]
    assert [(i["kind"], i["subject"]) for i in raised] == [("straggler", names()[3])] * 2


def test_target_down_and_cluster_floor_match_reference():
    up = {n: snap(5) for n in names()}
    down = dict(up, **{names()[3]: None})
    script = [up, up] + [down] * 4 + [up] * 3
    got = {pkg: drive(pkg, script, slos=m(pkg, "obs.watch").DEFAULT_SLOS
                      + ("epochs_per_s>=1.0",), engage_ticks=2, clear_ticks=2)
           for pkg in PKGS}
    assert json.dumps(got[PKGS[1]], sort_keys=True) == json.dumps(got[PKGS[0]], sort_keys=True)
    kinds = {(i["kind"], i["subject"]) for tick in got[PKGS[1]][0] for i in tick}
    assert ("target_down", names()[3]) in kinds and ("slo_epochs_per_s", "cluster") in kinds


def perf_script(n_names, slow_ticks, events=50):
    cum = {n: [0.0, 0.0] for n in n_names}

    def snaps(mean_by_name):
        out = {}
        for n in n_names:
            mean = mean_by_name.get(n, 0.001)
            cum[n][0] += mean * events
            cum[n][1] += events
            s = snap(20)
            s["metrics"] = {
                "hbbft_pump_segment_seconds_sum": [({"segment": "msg"}, cum[n][0])],
                "hbbft_pump_segment_seconds_count": [({"segment": "msg"}, float(cum[n][1]))]}
            out[n] = s
        return out
    return [snaps(x) for x in slow_ticks]


PROFILE = {"segments": {"msg": {"mean_s": 0.001}, "bogus": {"mean_s": "nan?"}},
           "epochs_per_s": 12.0}


def test_perf_sentinel_on_a_synthetic_profile_matches_reference():
    n2 = names(2)
    slow = {n2[1]: 0.003}
    ticks = [{}] * 6 + [slow] * 5 + [{}] * 3 + [slow] * 4
    got = {}
    for pkg in PKGS:
        w = m(pkg, "obs.watch")
        armed = drive(pkg, perf_script(n2, ticks), n=2, perf_profile=PROFILE,
                      perf_ratio=2.0, perf_min_events=10, engage_ticks=2, clear_ticks=2)
        quiet = drive(pkg, perf_script(n2, [{n2[0]: 0.005}] * 5, events=5), n=2,
                      perf_profile={"msg": 0.001}, perf_ratio=2.0, perf_min_events=10,
                      engage_ticks=2, clear_ticks=2)
        bare = drive(pkg, perf_script(n2, [{n2[0]: 0.05}] * 5), n=2,
                     engage_ticks=2, clear_ticks=2)
        got[pkg] = (w.normalize_perf_profile(PROFILE), armed, quiet, bare)
    assert json.dumps(got[PKGS[1]], sort_keys=True) == json.dumps(got[PKGS[0]], sort_keys=True)
    profile, armed, quiet, bare = got[PKGS[1]]
    assert profile == {"msg": 0.001}
    assert [(i["kind"], i["subject"]) for tick in armed[0] for i in tick] \
        == [("perf_regression", n2[1])] * 2
    assert not any(quiet[0]) and not any(bare[0])


STATUS = {"node": "0", "era": 0, "epoch": 7, "batches": 7, "mempool": 3,
          "peers_connected": 3, "committed_txs": 56, "faults_observed": 0,
          "decode_failures": 0, "replay_gaps": 0,
          "flight": {"records": 812, "segments": 1, "write_failures": 0},
          "guard": {"ingress": {"throttles": 1, "disconnects": 0},
                    "senderq_evictions": 0, "mempool_sheds": {"c1": 2}},
          "degraded": {"level": 0}, "vid": {"pending_retrievals": 0}}
METRICS = """# TYPE hbbft_phase_duration_seconds histogram
hbbft_phase_duration_seconds_bucket{phase="rbc_value",le="0.001"} 2
hbbft_phase_duration_seconds_bucket{phase="rbc_value",le="0.01"} 9
hbbft_phase_duration_seconds_bucket{phase="rbc_value",le="+Inf"} 10
hbbft_phase_duration_seconds_bucket{phase="aba_coin",le="0.01"} 4
hbbft_phase_duration_seconds_bucket{phase="aba_coin",le="+Inf"} 5
hbbft_load_shed_txs_total 3
"""
GW_STATUS = {"gateway": "gw0", "clients": 16, "pending": 2, "forward_queue": 0,
             "links": [{"link": 0, "node": "0", "connected": True, "inflight": 1},
                       {"link": 1, "node": "1", "connected": False, "inflight": 0}],
             "forwarded": 480, "commits_relayed": 30, "sheds": 0, "link_failovers": 1}
GW_METRICS = "hbbft_gw_client_drops_total 0\n"


def test_top_renders_a_fixed_snapshot_like_reference(monkeypatch):
    got = {}
    for pkg in PKGS:
        top = m(pkg, "obs.top")
        parse = m(pkg, "obs.metrics").parse_prometheus_text
        monkeypatch.setattr(top.time, "strftime", lambda fmt: "12:00:00")
        node = {"status": STATUS, "metrics": parse(METRICS), "health": {"status": "ok"}}
        later = json.loads(json.dumps(node))
        later["status"]["batches"] = 9
        gw = {"status": GW_STATUS, "metrics": parse(GW_METRICS), "health": None}
        tg, gws = targets(2), [("127.0.0.1", 9100)]
        got[pkg] = (top.render(tg, [node, None], [later, None], 2.0, gws, [gw]),
                    json.dumps(top.snapshot_doc(tg, [later, None], gws, [gw]), sort_keys=True))
    assert got[PKGS[1]] == got[PKGS[0]]
    text, doc = got[PKGS[1]][0], json.loads(got[PKGS[1]][1])
    assert "127.0.0.1:9001".ljust(22) + " DOWN" in text and "gw0" in text and "rbc_value" in text
    assert [n["up"] for n in doc["nodes"]] == [True, False] and len(doc["gateways"]) == 1
