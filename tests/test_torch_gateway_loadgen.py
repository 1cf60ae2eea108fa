"""The operator's edge: the port's client gateway and open-loop load
generator.

``LoadGenerator._make_wave`` and ``build_schedule`` give the reference's
transactions and stages for several shapes and seeds.  A 4-node port
``LocalCluster`` on ``device="cpu"`` (flight recorder on) runs behind a port
``Gateway`` with two node links authenticated by the config-derived keys;
the generator offers rate-paced open-loop load through the gateway only.
Every transaction the gateway admitted commits exactly once on every node,
by the nodes' flight journals (``commit`` trace records), and the gateway
relays the commits back; ``obs.top --json`` sees four node rows and one
gateway row; the journals audit clean.  The gateway's fair-share shed
reaches the hog client as ``ACK_SHED`` (``TxShedError``), as at a node.
Every scenario runs under ``asyncio.wait_for`` with a 30 s budget; the
reference's socket clusters are not started (their stop hangs on Python
3.12).  Tolerance: exact.
"""

import asyncio
import contextlib
import importlib
import io
import json
from collections import Counter

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")
BUDGET_S = 30.0


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


@pytest.mark.parametrize("shape", [dict(tx_bytes=64, wave_txs=8),
                                   dict(tx_bytes=250, wave_txs=16, salt="p3."),
                                   dict(tx_bytes=10, wave_txs=3)],
                         ids=["64B", "250B-salted", "short"])
def test_make_wave_matches_reference(shape):
    waves = {}
    for pkg in PKGS:
        lg = m(pkg, "net.loadgen")
        gen = lg.LoadGenerator([("127.0.0.1", 1)], b"x", lg.LoadShape(**shape))
        waves[pkg] = [gen._make_wave(c, w) for c in (0, 1, 15) for w in (0, 1, 999)]
    assert waves[PKGS[1]] == waves[PKGS[0]]
    flat = [tx for wave in waves[PKGS[1]] for tx in wave]
    assert len(set(flat)) == len(flat)


@pytest.mark.parametrize("seed", [0, 7, 9, 12345])
def test_build_schedule_matches_reference(seed):
    got = [[m(pkg, "net.loadgen").build_schedule(seed, stages=s, base_clients=4,
                                                 peak_clients=p, waves_per_client=2)
            for s, p in ((6, 32), (1, 4), (9, 100))] for pkg in PKGS]
    assert got[1] == got[0]


async def gateway_run(root):
    from hbbft_tpu_torch.net import ClusterConfig, LocalCluster
    from hbbft_tpu_torch.net.cluster import donor_key_fn
    from hbbft_tpu_torch.net.gateway import Gateway, node_verifier
    from hbbft_tpu_torch.net.loadgen import LoadGenerator, LoadShape
    from hbbft_tpu_torch.obs import top

    cfg = ClusterConfig(n=4, seed=41, batch_size=8, max_tx_bytes=4096,
                        flight_dir=root, device="cpu")
    cluster = LocalCluster(cfg)
    await cluster.start()
    try:
        gw = Gateway([cluster.addrs[i] for i in range(cfg.n)], cfg.cluster_id,
                     node_links=2, verify_node=node_verifier(donor_key_fn(cfg)))
        await gw.start()
        ohost, oport = await gw.start_obs()
        await gw.wait_links(2, timeout_s=BUDGET_S)
        shape = LoadShape(tx_bytes=250, clients=4, wave_txs=4, rate_tx_s=32.0,
                          duration_s=1.5, drain_s=5.0)
        gen = LoadGenerator([gw.addr], cfg.cluster_id, shape)
        report = await gen.run()
        admitted = gw.status_doc()["submissions"]["accepted"]
        while min(rt.committed_txs for rt in cluster.runtimes) < admitted:
            await asyncio.sleep(0.05)
        buf = io.StringIO()
        targets = ",".join(f"{h}:{p}" for h, p in cluster.metrics_addrs.values())
        with contextlib.redirect_stdout(buf):
            rc = await asyncio.to_thread(top.main, ["--json", "--targets", targets,
                                                     "--gateways", f"{ohost}:{oport}"])
        offered = {tx for c in range(shape.clients)
                   for w in range(report["offered_txs"] // shape.wave_txs)
                   for tx in gen._make_wave(c, w)}
        doc = gw.status_doc()
        await gw.stop()
        return report, doc, offered, rc, json.loads(buf.getvalue())
    finally:
        await cluster.stop()


def journal_commits(root, pkg="hbbft_tpu_torch"):
    """Per node, how often each trace id was journaled as committed."""
    flight, trace = m(pkg, "obs.flight"), m(pkg, "obs.trace")
    out = {}
    for d in flight.find_journal_dirs(root):
        j = flight.read_journal(d)
        out[j.node] = Counter(tid for _inc, rec in j.records
                              if isinstance(rec, trace.FlightTrace) and rec.stage == "commit"
                              for tid in trace.iter_tids(rec.tids))
    return out


def test_open_loop_through_the_gateway_commits_every_admitted_tx_once(tmp_path):
    from hbbft_tpu_torch.obs.audit import run_audit
    from hbbft_tpu_torch.obs.trace import trace_id

    root = str(tmp_path / "flight")
    report, doc, offered, rc, snapshot = asyncio.run(asyncio.wait_for(
        gateway_run(root), BUDGET_S))
    admitted = doc["submissions"]["accepted"]
    assert admitted > 0 and report["shed_txs"] == 0 and doc["sheds"] == 0
    assert report["offered_txs"] == report["submitted_txs"] + report["local_drops"]
    commits = journal_commits(root)
    assert len(commits) == 4
    offered_tids = {trace_id(tx) for tx in offered}
    for node, counts in commits.items():
        assert len(counts) == admitted, node
        assert set(counts.values()) == {1}, node
        assert set(counts) <= offered_tids, node
    assert doc["forwarded"] >= admitted and doc["commits_relayed"] >= admitted
    assert rc == 0 and len(snapshot["nodes"]) == 4 and len(snapshot["gateways"]) == 1
    assert all(n["up"] for n in snapshot["nodes"]) and snapshot["gateways"][0]["links_up"] == 2
    res, _ = run_audit([root])
    assert res.verdict == "clean" and len(res.chains) == 4


def test_gateway_shed_ack_semantics():
    from hbbft_tpu_torch.net.client import ClusterClient, Mempool, TxShedError, tx_digest
    from hbbft_tpu_torch.net.gateway import Gateway

    async def scenario():
        gw = Gateway([("127.0.0.1", 1)], b"shed-test", gateway_id="gw-shed", node_links=1,
                     redial_backoff_s=5.0, mempool=Mempool(capacity=4))
        await gw.start()
        try:
            hog = ClusterClient(gw.addr, b"shed-test", client_id="hog")
            await hog.connect()
            hog_txs = [b"hog-%d" % i for i in range(4)]
            assert await hog.submit_many(hog_txs) == [0] * 4
            waiter = asyncio.get_running_loop().create_task(
                hog.wait_committed(hog_txs[0], timeout_s=BUDGET_S))
            await asyncio.sleep(0.05)
            other = ClusterClient(gw.addr, b"shed-test", client_id="other")
            await other.connect()
            assert await other.submit(b"fair-1", retry_full=False) == 0
            with pytest.raises(TxShedError):
                await asyncio.wait_for(waiter, 10)
            assert int(gw._c_sheds.total()) == 1
            assert not gw.mempool.has_pending(tx_digest(hog_txs[0]))
            assert gw.mempool.has_pending(tx_digest(b"fair-1"))
            await hog.close()
            await other.close()
        finally:
            await gw.stop()

    asyncio.run(asyncio.wait_for(scenario(), BUDGET_S))


def test_gateway_logs_under_the_port():
    from hbbft_tpu_torch.net import gateway

    assert gateway.logger.name == "hbbft_tpu_torch.net"
