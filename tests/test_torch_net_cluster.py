"""The port's node runtime over real localhost sockets, held to its own gates.

A 4-node ``LocalCluster(ClusterConfig(device="cpu"))`` with ``encrypt=True``
and the flight recorder on, classic and VID: client transactions commit,
every node holds the same ledger-digest chain, ``/status`` and ``/flight``
are served, and ``stop()`` returns within 10 s on Python 3.12 even with a
client connected and an idle connection left open on a node's obs port
and on its consensus port (the reference's stop waits on such a connection
for ever).  A spy shows that the pump hands its merged share-set jobs to
``verify_dec_share_sets`` on the cluster's device.  A ``NodeRuntime`` of
each package built from the same ``ClusterConfig`` registers the same
metric names.  A port that ``hold_ports`` holds still binds in a child.
Every scenario runs under ``asyncio.wait_for`` with a 30 s budget.
"""

import asyncio
import json
import socket
import time

import pytest
import torch

from hbbft_tpu_torch.crypto import batch as B
from hbbft_tpu_torch.net import ClusterConfig, LocalCluster, framing
from hbbft_tpu_torch.obs.http import http_get

BUDGET_S = 30.0
STOP_S = 10.0


async def drive(cfg, txs_per_node=3):
    """Start ``cfg``'s cluster, commit every node's transactions through its
    own client, settle, read /status and /flight, stop.  Returns what the
    gates read."""
    cluster = LocalCluster(cfg)
    idle = []
    out = {}
    try:
        await cluster.start()
        clients = [await cluster.client(i, client_id=f"c{i}") for i in range(cfg.n)]
        txs = {i: [b"tx-%d-%d-" % (i, k) + bytes(40) for k in range(txs_per_node)]
               for i in range(cfg.n)}
        acks = await asyncio.gather(*(c.submit_many(txs[i]) for i, c in enumerate(clients)))
        assert all(a == framing.ACK_ACCEPTED for ack in acks for a in ack)
        lat = await asyncio.gather(*(c.wait_committed_many(txs[i], timeout_s=BUDGET_S)
                                     for i, c in enumerate(clients)))
        while len({len(rt.batches) for rt in cluster.runtimes}) != 1 or (
                cfg.vid and any(rt._retrieve.pending_count() for rt in cluster.runtimes)):
            await asyncio.sleep(0.02)
        host, port = cluster.metrics_addrs[0]
        out["status"] = [json.loads(await asyncio.to_thread(
            http_get, *cluster.metrics_addrs[i], "/status")) for i in range(cfg.n)]
        out["flight"] = await asyncio.to_thread(http_get, host, port, "/flight")
        out["prefix"] = cluster.common_digest_prefix()
        out["chains"] = {tuple(rt.digest_chain) for rt in cluster.runtimes}
        if cfg.vid:
            out["commitments"] = sum(len(b.commitments()) for b in cluster.runtimes[0].batches)
        out["latencies"] = [x for per in lat for x in per]
        # idle connections left open across stop(): one on node 0's obs
        # port, one on node 1's consensus port (no hello sent)
        for addr in (cluster.metrics_addrs[0], cluster.addrs[1]):
            sock = socket.create_connection(addr)
            sock.setblocking(False)
            idle.append(sock)
        await asyncio.sleep(0.05)
    finally:
        t = time.perf_counter()
        await asyncio.wait_for(cluster.stop(), STOP_S)
        out["stop_s"] = time.perf_counter() - t
        for sock in idle:
            sock.close()
    return out


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, BUDGET_S))


@pytest.mark.parametrize("vid", [False, True], ids=["classic", "vid"])
def test_four_node_cluster_commits_and_stops(vid, tmp_path, monkeypatch):
    jobs = []
    verify = B.verify_dec_share_sets

    def spy(batch_jobs, device="cuda"):
        jobs.append((len(batch_jobs), str(device)))
        return verify(batch_jobs, device=device)

    monkeypatch.setattr(B, "verify_dec_share_sets", spy)
    cfg = ClusterConfig(n=4, encrypt=True, vid=vid, device="cpu", flight_dir=str(tmp_path))
    out = run(drive(cfg))
    status = out["status"]
    assert len(out["chains"]) == 1 and len(out["prefix"]) == status[0]["batches"] >= 1
    assert {d["committed_txs"] for d in status} == {12}  # each transaction once
    assert {d["decode_failures"] for d in status} == {0}
    assert {d["peers_connected"] for d in status} == {3}
    assert all(d["flight"]["records"] > 0 and d["flight"]["write_failures"] == 0
               for d in status)
    assert out["flight"].count("\n") > 0 and json.loads(out["flight"].splitlines()[0])
    if vid:
        # every node fetched every other proposer's payload
        assert sum(d["vid"]["retrieved"] for d in status) == 3 * out["commitments"] > 0
        assert all(d["vid"]["mismatch"] == d["vid"]["failure"] == 0 for d in status)
        assert all(d["vid"]["pending_retrievals"] == 0 for d in status)
    # the pump's deferred seam: merged share-set jobs on the cluster's device
    assert jobs and {dev for _, dev in jobs} == {"cpu"}
    assert sum(n for n, _ in jobs) >= 4 * 4  # every node checks every proposal's set
    assert out["stop_s"] < STOP_S


def test_cluster_stop_returns_with_no_traffic(tmp_path):
    """A started, connected cluster that committed nothing stops promptly."""

    async def scenario():
        cluster = LocalCluster(ClusterConfig(n=4, device="cpu", flight_dir=str(tmp_path)))
        await cluster.start()
        await cluster.client(0)
        sock = socket.create_connection(cluster.metrics_addrs[2])
        t = time.perf_counter()
        try:
            await asyncio.wait_for(cluster.stop(), STOP_S)
        finally:
            sock.close()
        return time.perf_counter() - t

    assert run(scenario()) < STOP_S


def metric_names(pkg, vid):
    import importlib

    cluster = importlib.import_module(f"{pkg}.net.cluster")
    kw = {} if pkg == "hbbft_tpu" else {"device": "cpu"}
    cfg = cluster.ClusterConfig(n=4, encrypt=True, vid=vid, **kw)
    rt = cluster.build_runtime(cfg, cluster.generate_infos(cfg), 1)
    try:
        return sorted(rt.registry.names())
    finally:
        rt.pump._executor.shutdown(wait=True)


@pytest.mark.parametrize("vid", [False, True], ids=["classic", "vid"])
def test_runtime_metric_names_match_reference(vid):
    ref = metric_names("hbbft_tpu", vid)
    assert metric_names("hbbft_tpu_torch", vid) == ref
    assert "hbbft_pump_segment_seconds" in ref


def test_runtime_takes_the_stack_device(tmp_path):
    """The runtime's retrieval service and the stack it drives share the
    cluster's device."""
    from hbbft_tpu_torch.net.cluster import build_runtime, generate_infos

    cfg = ClusterConfig(n=4, encrypt=True, vid=True, device="cpu")
    rt = build_runtime(cfg, generate_infos(cfg), 0)
    try:
        assert rt._retrieve.device == rt.sq.algo.dhb.device == torch.device("cpu")
        assert rt.sq.algo.dhb.hb.defer_decrypt  # the pump's deferred seam is on
    finally:
        rt.pump._executor.shutdown(wait=True)


def test_listener_found_by_a_bind_not_a_connection():
    """``wait_listening`` finds a held port's listener without connecting
    to it (a bare connection to a node port is journaled as a refused
    hello)."""
    from hbbft_tpu_torch.net.cluster import _listening, find_free_base_port, hold_ports

    port = find_free_base_port(1)
    with hold_ports("127.0.0.1", [port]):
        assert not _listening("127.0.0.1", port)
        with socket.socket() as srv:
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind(("127.0.0.1", port))
            assert not _listening("127.0.0.1", port)  # bound, not listening
            srv.listen()
            assert _listening("127.0.0.1", port)
            srv.setblocking(False)
            with pytest.raises(BlockingIOError):
                srv.accept()  # the probe opened no connection


def test_held_ports_still_bind_in_a_child():
    """``hold_ports`` keeps a cluster's fixed ports bound while its nodes
    boot (no outgoing connection can take one as its local port), and a
    child process's listener still binds and serves a held port;
    ``wait_listening`` returns once it does."""
    import subprocess
    import sys

    from hbbft_tpu_torch.net.cluster import find_free_base_port, hold_ports, wait_listening

    port = find_free_base_port(1)
    child = ("import asyncio\n"
             "async def main():\n"
             f"    await asyncio.start_server(lambda r, w: w.close(), '127.0.0.1', {port})\n"
             "    await asyncio.sleep(5)\n"
             "asyncio.run(main())\n")
    with hold_ports("127.0.0.1", [port]):
        with socket.socket() as other, pytest.raises(OSError):
            other.bind(("127.0.0.1", port))  # held: a plain bind is refused
        proc = subprocess.Popen([sys.executable, "-c", child])
        try:
            wait_listening([("127.0.0.1", port)], [proc], BUDGET_S)
            assert proc.poll() is None
            socket.create_connection(("127.0.0.1", port), timeout=2.0).close()
        finally:
            proc.kill()
            proc.wait(timeout=BUDGET_S)
