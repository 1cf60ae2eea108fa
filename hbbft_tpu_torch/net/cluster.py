"""Cluster assembly: build QHB node runtimes, in-process or as processes.

One :class:`ClusterConfig` (n, seed, ports, batch size, encryption) fully
determines a cluster: every process derives the same BLS key material from
``NetworkInfo.generate_map(range(n), Random(seed))``, so nodes need no key
distribution — the config IS the deployment descriptor for localhost runs.

Two drivers share the builders:

- :class:`LocalCluster` — all runtimes on one asyncio loop with ephemeral
  ports (real sockets, one process): the harness of the tests and of
  ``chip_smoke.py``'s ``netsim`` phase;
- :func:`spawn_node` / ``python -m hbbft_tpu_torch.net.cluster --node-id I …`` —
  one OS process per node on ``base_port + i``: the deployment shape, which
  :func:`spawn_cluster` (``python -m hbbft_tpu_torch.cluster_launch``)
  starts whole.

Every node's device work runs on ``ClusterConfig.device`` (default
``"cuda"``): without a card the builders, ``LocalCluster``, ``spawn_node``
and the CLI raise unless it is ``"cpu"``.

``VirtualNet`` remains the deterministic single-process test harness; this
module is the path that runs the same protocol objects over real TCP.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import errno
import json
import os
import random
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.net.client import ClusterClient, Mempool
from hbbft_tpu_torch.net.runtime import NodeRuntime
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
from hbbft_tpu_torch.protocols.sender_queue import SenderQueue

Addr = Tuple[str, int]


@dataclass
class ClusterConfig:
    n: int = 4
    seed: int = 0
    host: str = "127.0.0.1"
    base_port: int = 0          # 0 → ephemeral ports (in-process only)
    batch_size: int = 8
    # per-tx admission ceiling (Mempool.max_tx_bytes); 0 keeps the
    # Mempool default (256 KiB).  batch_size × max_tx_bytes must fit in
    # half the wire blob cap, so MB-scale ingestion shapes (big batches
    # of small txs, or 64 KB txs) size this to the tx they carry
    max_tx_bytes: int = 0
    encrypt: bool = False       # TPKE-encrypt contributions
    # verifiable information dispersal (protocols/vid.py): propose
    # constant-size (root, cert) commitments and retrieve payloads
    # lazily post-commit, instead of reliable-broadcasting every full
    # contribution through the epoch — the WAN-asymmetry mode where one
    # bandwidth-starved node no longer drags every commit
    vid: bool = False
    heartbeat_s: float = 0.5
    dead_after_s: float = 3.0
    replay_retain_epochs: int = 64
    # bounded storage: per-peer replay-log byte ceiling (0 = epochs-only
    # retention) and flight-journal checkpoint retention in committed
    # batches (0 = segment-count cap only).  Truncations are counted
    # (`hbbft_node_replay_truncations_total`,
    # `hbbft_obs_flight_truncations_total`) and visible in /status.
    replay_retain_bytes: int = 0
    flight_retain_batches: int = 0
    # snapshot state-sync transfer chunk size (net/statesync.py)
    sync_chunk_bytes: int = 32 * 1024
    # obs endpoint (/metrics /status /spans /flight) base port: node i
    # serves on metrics_base_port + i; 0 → no fixed obs ports
    # (LocalCluster still opens ephemeral ones)
    metrics_base_port: int = 0
    # in-memory ledger-digest chain retention (the head + total length
    # never truncate; the flight journal keeps the full record on disk)
    digest_chain_retain: int = 4096
    # flight-recorder journal root: node i journals to
    # <flight_dir>/node-<i>; "" → recorder off
    flight_dir: str = ""
    flight_max_segment_bytes: int = 4 * 2**20
    flight_max_segments: int = 16
    # epochs kept in flight per node (net/scheduler.py): 1 = sequential
    # (today's behavior), N = epoch e+N-1's RBC/ABA may start while epoch
    # e still threshold-decrypts
    pipeline_depth: int = 1
    # outbound link shaping, "SRC>DST:SECONDS,…" (e.g. "3>0:0.02,3>1:0.02"
    # delays node 3's frames to nodes 0 and 1 by 20 ms); "" → no shaping
    link_delays: str = ""
    # named chaos preset (chaos.link.preset_shape: wan-100ms, lossy-1pct,
    # dup-reorder, partition-10s, bandwidth-64k) applied to every node's
    # egress through the shared LinkShaper hook; "" → no chaos shaping.
    # chaos_seed seeds the per-edge fault RNGs (-1 → the cluster seed):
    # same config, same seed, same faults — a campaign cell's scenario
    # is reproducible interactively (examples/cluster.py --chaos)
    chaos: str = ""
    chaos_seed: int = -1
    # slow-node shaping: node `slow_node` sleeps `slow_delay_s` before
    # every pump iteration (an overloaded validator) — the bench's
    # coin-exercise knob; -1 → nobody is slowed
    slow_node: int = -1
    slow_delay_s: float = 0.0
    # general form: per-node pump delays "NID:SECONDS,…" (e.g.
    # "0:0.04,3:0.02") — a heterogeneous cluster where every validator
    # runs at its own speed; entries here override slow_node/slow_delay_s
    step_delays: str = ""
    # ingress-budget overrides (overload defense, net/transport.py):
    # 0 keeps the IngressBudget defaults (sized far above honest
    # traffic); flood chaos cells tighten them so the guard engages
    # within a short run
    ingress_bytes_per_s: float = 0.0
    ingress_burst_bytes: float = 0.0
    ingress_max_inflight: int = 0
    ingress_decode_strikes: int = 0
    ingress_throttle_strikes: int = 0
    # per-peer ingress worker threads (net/ingress.py): framing + decode
    # run off the event loop, feeding the pump decoded batches.  Off by
    # default — it buys wall-clock only where spare cores exist (thread
    # switches cost more than they save on a saturated single core)
    ingress_workers: bool = False
    # transport authentication (net/transport.py security model):
    # node-role hellos are challenge–response proven with the per-era
    # keys; auth=False reverts to the identification-only legacy
    # handshake (trusted-fabric benchmarks, protocol archaeology).
    # auth_grace_s bounds the previous-era key window during DKG
    # rotations (counted hbbft_guard_auth_stale_era_total).
    auth: bool = True
    auth_grace_s: float = 30.0
    # guard-driven adaptive degradation (net/degrade.py): shrink the
    # proposed batch size / mempool admission under sustained guard
    # pressure instead of riding the buffers into their cliff-edge caps
    degrade: bool = True
    # the controller's raise arm (opt-in): under sustained benign slack
    # (perf-plane headroom + real demand) raise batch size / mempool
    # admission up to this many doubling boosts toward the 8x ceilings;
    # 0 keeps the ladder degrade-only (chaos verdicts unchanged)
    max_boost: int = 0
    # raise-arm tuning (only consulted when max_boost > 0): clean
    # windows per boost step and the headroom floor that counts as
    # slack — a loaded shared box may never see the 0.6 default
    raise_windows: int = 10
    raise_headroom: float = 0.6
    # class-selective shaping: the listed nodes ("0,1") hold their
    # outbound BINARY-AGREEMENT traffic (BVal/Aux/Conf/Coin/Term) for
    # `aba_out_delay_s` while RBC flows normally.  Decorrelating ABA
    # progress from RBC delivery is what genuinely splits Subset's
    # accept/give-up votes (plain per-link delay cannot: the RBC echo
    # relay re-equalizes deliveries) — the honest trigger for real
    # threshold-coin rounds.  "" → nobody shaped.
    aba_delay_nodes: str = ""
    aba_out_delay_s: float = 0.0
    # narrow the hold to specific phase classes (comma list of span
    # names, e.g. "aba_conf"); "" → every aba_* class
    aba_out_classes: str = ""
    # where every node's protocol stack runs its device work (the
    # threshold-decrypt share-set folds, and the erasure products under
    # HBBFT_ERASURE_BACKEND=device): "cuda" raises without a card, "cpu"
    # runs the kernels' plain PyTorch versions
    device: str = "cuda"

    def link_delays_for(self, nid: int) -> Dict[int, float]:
        """This node's outbound per-peer delays parsed from link_delays."""
        out: Dict[int, float] = {}
        if not self.link_delays:
            return out
        for entry in self.link_delays.split(","):
            entry = entry.strip()
            if not entry:
                continue
            path, _, secs = entry.partition(":")
            src, _, dst = path.partition(">")
            if not secs or not dst:
                raise ValueError(f"bad link_delays entry {entry!r} "
                                 "(want SRC>DST:SECONDS)")
            if int(src) == nid:
                out[int(dst)] = float(secs)
        return out

    def step_delay_for(self, nid: int) -> float:
        """This node's pump delay: step_delays map, else slow_node."""
        if self.step_delays:
            for entry in self.step_delays.split(","):
                entry = entry.strip()
                if not entry:
                    continue
                node, _, secs = entry.partition(":")
                if not secs:
                    raise ValueError(f"bad step_delays entry {entry!r} "
                                     "(want NID:SECONDS)")
                if int(node) == nid:
                    return float(secs)
        return self.slow_delay_s if nid == self.slow_node else 0.0

    def chaos_shaper_for(self, nid: int):
        """This node's LinkShaper under the configured chaos preset (one
        shaper per transport; the seed is shared so every node draws the
        same per-edge fault streams)."""
        if not self.chaos or self.chaos == "none":
            return None
        from hbbft_tpu_torch.chaos.link import LinkShaper, preset_shape

        seed = self.seed if self.chaos_seed < 0 else self.chaos_seed
        return LinkShaper(preset_shape(self.chaos, self.n), seed=seed)

    def ingress_kwargs(self) -> Optional[Dict[str, float]]:
        """Non-default IngressBudget overrides, or None (defaults)."""
        out: Dict[str, float] = {}
        if self.ingress_bytes_per_s > 0:
            out["bytes_per_s"] = self.ingress_bytes_per_s
        if self.ingress_burst_bytes > 0:
            out["burst_bytes"] = self.ingress_burst_bytes
        if self.ingress_max_inflight > 0:
            out["max_inflight_frames"] = self.ingress_max_inflight
        if self.ingress_decode_strikes > 0:
            out["decode_strikes"] = self.ingress_decode_strikes
        if self.ingress_throttle_strikes > 0:
            out["throttle_strikes"] = self.ingress_throttle_strikes
        return out or None

    def aba_delay_for(self, nid: int) -> float:
        """This node's outbound ABA-class hold, from aba_delay_nodes."""
        if not self.aba_delay_nodes or self.aba_out_delay_s <= 0:
            return 0.0
        shaped = {int(x) for x in self.aba_delay_nodes.split(",") if x}
        return self.aba_out_delay_s if nid in shaped else 0.0

    @property
    def cluster_id(self) -> bytes:
        # VID and classic clusters must never cross-connect (their batch
        # flavors hash differently); non-VID ids stay byte-identical
        # with earlier releases
        return b"hbbft-net/%d/%d/%d" % (self.n, self.seed,
                                        1 if self.encrypt else 0) + (
            b"/vid" if self.vid else b"")

    def addr(self, nid: int) -> Addr:
        if self.base_port == 0:
            raise ValueError("base_port 0 has no fixed addresses")
        return (self.host, self.base_port + nid)

    def addr_map(self) -> Dict[int, Addr]:
        return {nid: self.addr(nid) for nid in range(self.n)}

    def metrics_addr(self, nid: int) -> Addr:
        if self.metrics_base_port == 0:
            raise ValueError("metrics_base_port 0 has no fixed addresses")
        return (self.host, self.metrics_base_port + nid)

    def node_flight_dir(self, nid: int) -> Optional[str]:
        if not self.flight_dir:
            return None
        return os.path.join(self.flight_dir, f"node-{nid}")


def generate_infos(cfg: ClusterConfig) -> Dict[int, NetworkInfo]:
    return NetworkInfo.generate_map(
        list(range(cfg.n)), random.Random(cfg.seed)
    )


def node_secret_key(cfg: ClusterConfig, nid: int,
                    infos: Optional[Dict[int, NetworkInfo]] = None):
    """Node ``nid``'s plain BLS secret key under this config.  Genesis
    members (``nid < cfg.n``) use their generated keypair; later joiners
    derive a fresh deterministic keypair from the cluster seed — the
    public half is what existing validators vote in."""
    from hbbft_tpu_torch.crypto import tc

    if nid < cfg.n:
        if infos is None:
            infos = generate_infos(cfg)
        return infos[nid].secret_key()
    return tc.SecretKey.random(
        random.Random(cfg.seed * 100_000 + 9000 + nid))


def donor_key_fn(cfg: ClusterConfig):
    """Donor-authentication resolver for state-sync joins: donor node
    id -> config-derived plain public key (genesis members and derived
    joiners alike), ``None`` for anything else — an unknown id fails
    the statesync identity challenge instead of being trusted."""
    infos = generate_infos(cfg)

    def key(nid):
        if isinstance(nid, int) and 0 <= nid:
            return node_secret_key(cfg, nid, infos).public_key()
        return None

    return key


def peer_addr_book(cfg: ClusterConfig):
    """The deployment address book: membership says WHO may join
    (consensus state); this says WHERE a member listens (config-derived
    ports).  Only meaningful with fixed ports."""
    if cfg.base_port == 0:
        return None
    return lambda nid: ((cfg.host, cfg.base_port + nid)
                        if isinstance(nid, int) and nid >= 0 else None)


def build_algo(cfg: ClusterConfig, infos: Dict[int, NetworkInfo],
               nid: int) -> SenderQueue:
    """The standard node stack: SenderQueue(QHB(DHB)) with per-node seeded
    RNGs derived from the cluster seed (same-seed-same-trace), its device
    work on ``cfg.device``."""
    dhb = DynamicHoneyBadger(
        infos[nid],
        infos[nid].secret_key(),
        rng=random.Random(cfg.seed * 100_000 + 7000 + nid),
        encryption_schedule=(
            EncryptionSchedule.always() if cfg.encrypt
            else EncryptionSchedule.never()
        ),
        device=cfg.device,
    )
    if cfg.vid:
        from hbbft_tpu_torch.protocols.vid import VidQueueingHoneyBadger

        qhb = VidQueueingHoneyBadger(
            dhb, batch_size=cfg.batch_size,
            rng=random.Random(cfg.seed * 100_000 + 8000 + nid),
        )
    else:
        qhb = QueueingHoneyBadger(
            dhb, batch_size=cfg.batch_size,
            rng=random.Random(cfg.seed * 100_000 + 8000 + nid),
        )
    return SenderQueue(qhb)


def _shared_runtime_kwargs(cfg: ClusterConfig, nid: int) -> dict:
    return dict(
        mempool=(Mempool(max_tx_bytes=cfg.max_tx_bytes)
                 if cfg.max_tx_bytes else None),
        seed=cfg.seed * 1000 + nid,
        heartbeat_s=cfg.heartbeat_s,
        dead_after_s=cfg.dead_after_s,
        replay_retain_epochs=cfg.replay_retain_epochs,
        replay_retain_bytes=cfg.replay_retain_bytes,
        flight_retain_batches=cfg.flight_retain_batches,
        sync_chunk_bytes=cfg.sync_chunk_bytes,
        peer_addr_book=peer_addr_book(cfg),
        digest_chain_retain=cfg.digest_chain_retain,
        flight_dir=cfg.node_flight_dir(nid),
        flight_max_segment_bytes=cfg.flight_max_segment_bytes,
        flight_max_segments=cfg.flight_max_segments,
        pipeline_depth=cfg.pipeline_depth,
        step_delay_s=cfg.step_delay_for(nid),
        aba_out_delay_s=cfg.aba_delay_for(nid),
        aba_out_classes=cfg.aba_out_classes,
        ingress_kwargs=cfg.ingress_kwargs(),
        ingress_workers=cfg.ingress_workers,
        auth=cfg.auth,
        auth_grace_s=cfg.auth_grace_s,
        degrade=cfg.degrade,
        degrade_kwargs=(dict(max_boost=cfg.max_boost,
                             raise_windows=cfg.raise_windows,
                             raise_headroom=cfg.raise_headroom)
                        if cfg.max_boost > 0 else None),
    )


def build_runtime(cfg: ClusterConfig, infos: Dict[int, NetworkInfo],
                  nid: int, **kwargs) -> NodeRuntime:
    kwargs.setdefault("shaper", cfg.chaos_shaper_for(nid))
    merged = _shared_runtime_kwargs(cfg, nid)
    merged["link_delays"] = cfg.link_delays_for(nid)
    merged.update(kwargs)
    return NodeRuntime(build_algo(cfg, infos, nid), cfg.cluster_id,
                       **merged)


def build_joiner_runtime(cfg: ClusterConfig, snap, nid: int,
                         **kwargs) -> NodeRuntime:
    """A runtime activated from a state-sync :class:`JoinSnapshot`
    instead of genesis config: the standard node stack built via
    ``snapshot.build_joiner`` (DKG-transcript share derivation included)
    with the ledger-digest chain seeded at the snapshot's era boundary.

    Works for brand-new validators (``nid ≥ cfg.n``) and for genesis
    members rejoining after an outage that outlived replay retention
    (their config netinfo backs share derivation across
    encryption-schedule rotations)."""
    from hbbft_tpu_torch.snapshot import build_joiner

    infos = generate_infos(cfg)
    sq = build_joiner(
        snap, nid, node_secret_key(cfg, nid, infos),
        batch_size=cfg.batch_size,
        rng_seed=cfg.seed * 100_000 + 7000 + nid,
        config_netinfo=infos.get(nid),
        device=cfg.device,
    )
    # same egress shaping as a genesis member: a joiner in a
    # chaos-configured cluster is NOT exempt from the chaos
    kwargs.setdefault("shaper", cfg.chaos_shaper_for(nid))
    merged = _shared_runtime_kwargs(cfg, nid)
    merged["link_delays"] = cfg.link_delays_for(nid)
    merged["ledger_seed"] = (snap.chain_head, snap.chain_len)
    merged.update(kwargs)
    return NodeRuntime(sq, cfg.cluster_id, **merged)


# -- in-process cluster ------------------------------------------------------


class LocalCluster:
    """All n runtimes on this process's event loop, ephemeral ports."""

    def __init__(self, cfg: ClusterConfig, **runtime_kwargs):
        resolve_device(cfg.device)  # no card and no device="cpu": raise here
        self.cfg = cfg
        self.runtime_kwargs = runtime_kwargs
        self.runtimes: List[NodeRuntime] = []
        self.addrs: Dict[int, Addr] = {}
        self.metrics_addrs: Dict[int, Addr] = {}
        self._clients: List[ClusterClient] = []
        self._infos: Dict[int, NetworkInfo] = {}

    async def start(self) -> None:
        self._infos = generate_infos(self.cfg)
        self.runtimes = [
            build_runtime(self.cfg, self._infos, nid,
                          **self.runtime_kwargs)
            for nid in range(self.cfg.n)
        ]
        for nid, rt in enumerate(self.runtimes):
            # base_port set → fixed addresses (restart_node can rebind);
            # 0 → ephemeral as before
            self.addrs[nid] = await rt.start(
                self.cfg.host,
                self.cfg.base_port + nid if self.cfg.base_port else 0,
            )
            self.metrics_addrs[nid] = await rt.start_obs(
                self.cfg.host,
                (self.cfg.metrics_base_port + nid
                 if self.cfg.metrics_base_port else 0),
            )
        for rt in self.runtimes:
            rt.connect(self.addrs)

    async def stop(self) -> None:
        for client in self._clients:
            await client.close()
        for rt in self.runtimes:
            await rt.stop()

    async def restart_node(self, nid: int) -> None:
        """Kill/restart churn primitive: stop runtime ``nid`` and rebuild
        it from scratch at (0, 0) on its old address (requires fixed
        ports, i.e. ``cfg.base_port``).  Peers' senders keep dialing the
        address and the fresh hello triggers the SenderQueue replay
        catch-up; with a flight dir the journal's incarnation bumps, so
        the restart is visible to the auditor."""
        if not self.cfg.base_port:
            raise ValueError("restart_node needs fixed ports "
                             "(ClusterConfig.base_port)")
        await self.runtimes[nid].stop()
        rt = build_runtime(self.cfg, self._infos, nid,
                           **self.runtime_kwargs)
        self.runtimes[nid] = rt
        await rt.start(self.cfg.host, self.cfg.base_port + nid)
        self.metrics_addrs[nid] = await rt.start_obs(
            self.cfg.host,
            (self.cfg.metrics_base_port + nid
             if self.cfg.metrics_base_port else 0),
        )
        rt.connect(self.addrs)

    def vote_change(self, change) -> None:
        """Queue the same signed membership vote on every live runtime
        (votes commit through contributions; a majority rotates the
        era)."""
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import ChangeInput

        for rt in self.runtimes:
            rt.pump.enqueue("input", ChangeInput(change))

    def vote_to_add(self, nid: int) -> None:
        """Every validator votes to add ``nid`` (its config-derived
        public key) to the validator set."""
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import Change

        pk = node_secret_key(self.cfg, nid, self._infos).public_key()
        keys = dict(
            self.runtimes[0].sq.algo.dhb.netinfo.public_key_map())
        keys[nid] = pk
        self.vote_change(Change.node_change(keys))

    def vote_to_readd(self) -> None:
        """Vote a node-change to the CURRENT key map: a no-op membership
        change that still runs a full DKG and rotates the era — the
        checkpoint rotation that re-arms snapshot joins with a fresh
        transcript (how a restarted-beyond-retention validator gets a
        boundary to recover through)."""
        from hbbft_tpu_torch.protocols.dynamic_honey_badger import Change

        keys = dict(
            self.runtimes[0].sq.algo.dhb.netinfo.public_key_map())
        self.vote_change(Change.node_change(keys))

    async def wait_snapshot(self, min_era: int,
                            timeout_s: float = 60.0) -> None:
        """Until every live runtime serves a join snapshot of era ≥
        ``min_era`` (i.e. the voted rotation completed everywhere)."""

        async def _wait():
            while any(
                rt.sync_store.manifest is None
                or rt.sync_store.manifest.era < min_era
                for rt in self.runtimes
            ):
                await asyncio.sleep(0.02)

        await asyncio.wait_for(_wait(), timeout_s)

    async def join_node(self, nid: int, *, timeout_s: float = 90.0,
                        donors: Optional[List[int]] = None
                        ) -> NodeRuntime:
        """The full membership-lifecycle join: vote ``nid`` in, wait for
        the DKG rotation, state-sync the boundary snapshot from donors,
        activate the joiner (share-complete, zero history replay), and
        wire it into the cluster.  Requires fixed ports
        (``cfg.base_port``)."""
        if not self.cfg.base_port:
            raise ValueError("join_node needs fixed ports "
                             "(ClusterConfig.base_port)")
        self.vote_to_add(nid)
        min_era = max(rt.current_key()[0] for rt in self.runtimes) + 1
        await self.wait_snapshot(min_era, timeout_s)
        return await self.activate_from_snapshot(
            nid, donors=donors, min_manifest_confirm=2)

    async def activate_from_snapshot(
        self, nid: int, *, donors: Optional[List[int]] = None,
        min_manifest_confirm: int = 1,
    ) -> NodeRuntime:
        """State-sync ``nid`` from live donors and start it — the shared
        tail of a brand-new join and a restarted-beyond-retention
        recovery."""
        from hbbft_tpu_torch.net.statesync import StateSyncClient

        from hbbft_tpu_torch.obs.metrics import Registry

        donor_addrs = [self.addrs[d] for d in (donors or
                       [d for d in self.addrs if d != nid])]
        # the bootstrap transfer's counters live on the SAME registry the
        # runtime will serve on /metrics — the join story stays scrapeable
        registry = self.runtime_kwargs.get("registry") or Registry()
        snap = await StateSyncClient(
            donor_addrs, self.cfg.cluster_id,
            client_id=f"statesync-{nid}", seed=self.cfg.seed,
            min_manifest_confirm=min_manifest_confirm,
            registry=registry,
            donor_key=donor_key_fn(self.cfg) if self.cfg.auth else None,
        ).fetch()
        kwargs = dict(self.runtime_kwargs)
        kwargs["registry"] = registry
        # DKG-transcript replay (BLS row decryption + commitment checks)
        # is CPU-heavy sync work — off the event loop, or the donors
        # sharing this loop would miss heartbeats mid-join
        rt = await asyncio.to_thread(
            build_joiner_runtime, self.cfg, snap, nid, **kwargs)
        addr = (self.cfg.host, self.cfg.base_port + nid)
        if nid < len(self.runtimes):
            self.runtimes[nid] = rt
        else:
            self.runtimes.append(rt)
        self.addrs[nid] = addr
        await rt.start(*addr)
        self.metrics_addrs[nid] = await rt.start_obs(
            self.cfg.host,
            (self.cfg.metrics_base_port + nid
             if self.cfg.metrics_base_port else 0),
        )
        # the joiner dials every existing member; members accept its
        # hello through the membership-resolved dynamic-peer path and
        # dial back (transport.peer_resolver)
        rt.connect(dict(self.addrs))
        return rt

    async def client(self, nid: int,
                     client_id: str = "client",
                     trace_dir: Optional[str] = None) -> ClusterClient:
        client = ClusterClient(
            self.addrs[nid], self.cfg.cluster_id, client_id=client_id,
            trace_dir=trace_dir,
        )
        await client.connect()
        self._clients.append(client)
        return client

    async def wait_epochs(self, min_batches: int,
                          timeout_s: float = 60.0) -> None:
        """Until every runtime has committed ≥ ``min_batches`` batches."""

        async def _wait():
            while any(
                len(rt.batches) < min_batches for rt in self.runtimes
            ):
                await asyncio.sleep(0.02)

        await asyncio.wait_for(_wait(), timeout_s)

    def common_digest_prefix(self) -> List[str]:
        """The agreed ledger-digest chain across all runtimes wherever
        their RETAINED chains overlap (chains are checkpointed — see
        ``NodeRuntime.digest_chain_retain``); raises if any node's chain
        *conflicts* (same index, different digest)."""
        tails = [(rt.digest_chain_offset, rt.digest_chain)
                 for rt in self.runtimes]
        lo = max(off for off, _c in tails)
        hi = min(off + len(c) for off, c in tails)
        prefix: List[str] = []
        for i in range(lo, hi):
            vals = {c[i - off] for off, c in tails}
            if len(vals) != 1:
                raise AssertionError(
                    f"ledger fork at batch {i}: {sorted(vals)}"
                )
            prefix.append(tails[0][1][i - tails[0][0]])
        return prefix


def assert_status_chains_consistent(docs) -> int:
    """Every pair of node STATUS documents must agree wherever their
    ledger digest chains overlap; returns how many indices were checked.
    The cross-process sibling of :meth:`LocalCluster.common_digest_prefix`.
    """
    checked = 0
    tails = [(d["digest_chain_offset"], d["digest_chain"]) for d in docs]
    lo = max(off for off, _c in tails)
    hi = min(off + len(c) for off, c in tails)
    for i in range(lo, hi):
        vals = {c[i - off] for off, c in tails}
        if len(vals) != 1:
            raise AssertionError(f"ledger fork at batch {i}: {sorted(vals)}")
        checked += 1
    return checked


# -- multi-process cluster ---------------------------------------------------


def find_free_base_port(n: int, lo: int = 23000, hi: int = 52000) -> int:
    """A base port with n consecutive free TCP ports on localhost."""
    for base in range(lo, hi, max(n, 1)):
        socks = []
        try:
            for i in range(n):
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        # hblint: disable=fault-swallowed-drop (port-availability probe:
        # a busy port is the expected negative result, not dropped input)
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range found")


def node_command(cfg: ClusterConfig, nid: int) -> List[str]:
    cmd = [
        sys.executable, "-m", "hbbft_tpu_torch.net.cluster",
        "--nodes", str(cfg.n),
        "--node-id", str(nid),
        "--seed", str(cfg.seed),
        "--base-port", str(cfg.base_port),
        "--batch-size", str(cfg.batch_size),
    ]
    if cfg.max_tx_bytes:
        cmd += ["--max-tx-bytes", str(cfg.max_tx_bytes)]
    if cfg.metrics_base_port:
        cmd += ["--metrics-port", str(cfg.metrics_base_port + nid)]
    if cfg.flight_dir:
        cmd += ["--flight-dir", cfg.flight_dir]
    if cfg.encrypt:
        cmd.append("--encrypt")
    if cfg.vid:
        cmd.append("--vid")
    if cfg.pipeline_depth != 1:
        cmd += ["--pipeline-depth", str(cfg.pipeline_depth)]
    if cfg.device != "cuda":
        cmd += ["--device", cfg.device]
    if cfg.heartbeat_s != 0.5:
        cmd += ["--heartbeat-s", str(cfg.heartbeat_s)]
    if cfg.dead_after_s != 3.0:
        cmd += ["--dead-after-s", str(cfg.dead_after_s)]
    if cfg.link_delays:
        cmd += ["--link-delays", cfg.link_delays]
    if cfg.chaos:
        cmd += ["--chaos", cfg.chaos]
        if cfg.chaos_seed >= 0:
            cmd += ["--chaos-seed", str(cfg.chaos_seed)]
    if cfg.ingress_workers:
        cmd.append("--ingress-workers")
    if not cfg.auth:
        cmd.append("--no-auth")
    if cfg.auth_grace_s != 30.0:
        cmd += ["--auth-grace-s", str(cfg.auth_grace_s)]
    if not cfg.degrade:
        cmd.append("--no-degrade")
    if cfg.max_boost > 0:
        cmd += ["--max-boost", str(cfg.max_boost)]
        if cfg.raise_windows != 10:
            cmd += ["--raise-windows", str(cfg.raise_windows)]
        if cfg.raise_headroom != 0.6:
            cmd += ["--raise-headroom", str(cfg.raise_headroom)]
    if cfg.step_delay_for(nid) > 0:
        cmd += ["--step-delay", str(cfg.step_delay_for(nid))]
    if cfg.aba_delay_for(nid) > 0:
        cmd += ["--aba-out-delay", str(cfg.aba_out_delay_s)]
        if cfg.aba_out_classes:
            cmd += ["--aba-out-classes", cfg.aba_out_classes]
    return cmd


def spawn_node(cfg: ClusterConfig, nid: int, *, join: bool = False,
               **popen_kwargs) -> subprocess.Popen:
    """One node as a child process on ``cfg.device`` (``--device``).
    ``join=True`` spawns the state-sync joiner flow (``--join``) instead of
    a genesis member."""
    resolve_device(cfg.device)  # raise here, not in the child
    env = dict(os.environ)
    cwd = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    )))
    cmd = join_command(cfg, nid) if join else node_command(cfg, nid)
    return subprocess.Popen(cmd, env=env, cwd=cwd, **popen_kwargs)


@contextlib.contextmanager
def hold_ports(host: str, ports):
    """Keep ``ports`` bound (``SO_REUSEADDR``, not listening) while the
    block runs.  A child's listener still binds them (asyncio sets
    ``SO_REUSEADDR`` too), but no outgoing connection is given one as its
    local port meanwhile — where the kernel's ephemeral port range covers
    the cluster's fixed ports, the first nodes' dials could otherwise take
    a later node's port before that node binds it."""
    socks = []
    try:
        for port in ports:
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            socks.append(s)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind((host, port))
        yield
    finally:
        for s in socks:
            s.close()


def _listening(host: str, port: int) -> bool:
    """Whether a socket listens on ``(host, port)``, found without
    connecting to it (a bare connection to a node port is journaled as a
    refused hello): an ``SO_REUSEADDR`` bind is refused only where a
    socket listens, and :func:`hold_ports`' sockets do not."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            s.bind((host, port))
        # hblint: disable=fault-swallowed-drop (bind probe: the errno IS
        # the verdict — EADDRINUSE means a listener holds the port; no
        # input is dropped)
        except OSError as exc:
            return exc.errno == errno.EADDRINUSE
    return False


def wait_listening(addrs, procs, timeout_s: float) -> None:
    """Until every address has a listener or its process has exited, at
    most ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    for (host, port), proc in zip(addrs, procs):
        while proc.poll() is None and time.monotonic() < deadline \
                and not _listening(host, port):
            time.sleep(0.2)


def spawn_cluster(cfg: ClusterConfig, boot_timeout_s: float = 300.0,
                  **popen_kwargs) -> Dict[int, subprocess.Popen]:
    """Every node of ``cfg`` as a child process (:func:`spawn_node`).  On a
    CUDA device the kernels are built here first, once: children that
    found them stale would each start one ``nvcc`` a kernel, all at once.
    The node ports, and the obs ports where there are any, stay held
    (:func:`hold_ports`) until each has its node's listener or the node
    has exited, at most ``boot_timeout_s``."""
    if resolve_device(cfg.device).type == "cuda":
        from hbbft_tpu_torch import _build

        _build.build_all()
    addrs = [cfg.addr(nid) for nid in range(cfg.n)]
    if cfg.metrics_base_port:
        addrs += [cfg.metrics_addr(nid) for nid in range(cfg.n)]
    with hold_ports(cfg.host, [p for _h, p in addrs]):
        procs = {nid: spawn_node(cfg, nid, **popen_kwargs) for nid in range(cfg.n)}
        owners = list(procs.values()) * (len(addrs) // cfg.n)
        wait_listening(addrs, owners, boot_timeout_s)
    return procs


async def connect_when_up(cfg: ClusterConfig, nid: int, *,
                          client_id: Optional[str] = None,
                          timeout_s: float = 120.0,
                          trace_dir: Optional[str] = None) -> ClusterClient:
    """A connected :class:`ClusterClient` for node ``nid``, retrying while
    the node process boots.  ``trace_dir`` journals the client's side of
    the per-tx causal trace (obs.trace) for ``obs.critpath``."""
    deadline = time.monotonic() + timeout_s
    while True:
        client = ClusterClient(cfg.addr(nid), cfg.cluster_id,
                               client_id=client_id or f"client-{nid}",
                               trace_dir=trace_dir)
        try:
            await client.connect()
            return client
        except (OSError, asyncio.TimeoutError):
            await client.close()
            if time.monotonic() > deadline:
                raise TimeoutError(f"node {nid} never came up")
            await asyncio.sleep(0.3)


def shutdown_procs(procs, timeout_s: float = 15.0) -> None:
    """SIGTERM every live node process, escalating to SIGKILL."""
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        # hblint: disable=fault-swallowed-drop (escalation, not a drop:
        # a node ignoring SIGTERM for timeout_s is SIGKILLed)
        except subprocess.TimeoutExpired:
            p.kill()


async def _serve_runtime(rt: NodeRuntime) -> None:
    """Serve a started runtime until SIGTERM/SIGINT (shared tail of
    ``run_node`` and ``run_join_node``): a dead step pump is a dead
    node, so its exception is surfaced instead of serving sockets for a
    consensus engine that no longer runs."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    stop_task = asyncio.ensure_future(stop.wait())
    done, _pending = await asyncio.wait(
        {stop_task, rt.pump.task}, return_when=asyncio.FIRST_COMPLETED
    )
    if rt.pump.task in done:
        stop_task.cancel()
        exc = rt.pump.task.exception()
        if exc is not None:
            raise exc


async def run_join_node(cfg: ClusterConfig, nid: int,
                        metrics_port: int = 0,
                        donors: Optional[List[int]] = None,
                        min_manifest_confirm: int = 2) -> None:
    """Join a LIVE cluster as a fresh OS process — the multi-process
    face of the membership lifecycle (``LocalCluster.join_node``
    drives the same path in-process):

    1. the existing validators must already have voted ``nid`` in (its
       config-derived public key) and completed the DKG rotation, so
       every donor serves an era-boundary join snapshot;
    2. this process state-syncs the snapshot from the donors (chunked,
       CRC'd, multi-donor-confirmed — ``net/statesync.py``), derives
       its secret key share from the committed DKG transcript, and
    3. activates at the era boundary with zero history replay, dialing
       every existing member; members accept its hello through the
       membership-resolved dynamic-peer path and dial back.

    ``python -m hbbft_tpu_torch.net.cluster --join --node-id I …`` lands here.
    """
    from hbbft_tpu_torch.net.statesync import StateSyncClient

    donor_ids = [d for d in (donors if donors is not None
                             else range(cfg.n)) if d != nid]
    if not donor_ids:
        raise ValueError("--join needs at least one donor node")
    snap = await StateSyncClient(
        [cfg.addr(d) for d in donor_ids], cfg.cluster_id,
        client_id=f"statesync-{nid}", seed=cfg.seed,
        min_manifest_confirm=min(min_manifest_confirm, len(donor_ids)),
        donor_key=donor_key_fn(cfg) if cfg.auth else None,
    ).fetch()
    print(f"node {nid} state-synced era {snap.era} snapshot "
          f"(chain len {snap.chain_len})", flush=True)
    rt = build_joiner_runtime(cfg, snap, nid)
    try:
        host, port = cfg.addr(nid)
        await rt.start(host, port)
        if metrics_port:
            m_host, m_port = await rt.start_obs(host, metrics_port)
            print(f"node {nid} obs endpoint on http://{m_host}:{m_port}"
                  f"/metrics", flush=True)
        rt.connect({d: cfg.addr(d) for d in donor_ids})
        print(f"node {nid} joined, listening on {host}:{port}",
              flush=True)
        await _serve_runtime(rt)
    except BaseException as exc:
        rt.flight_crash(exc)
        raise
    await rt.stop()


def join_command(cfg: ClusterConfig, nid: int) -> List[str]:
    """The ``--join`` subprocess invocation for ``nid`` under ``cfg``."""
    cmd = node_command(cfg, nid)
    # --node-id validation differs under --join (a joiner's id may be
    # outside 0..n-1), so the flag must precede nothing in particular —
    # append is fine
    cmd.append("--join")
    return cmd


async def run_node(cfg: ClusterConfig, nid: int,
                   metrics_port: int = 0) -> None:
    """Run one node forever (the subprocess entry body).

    ``HBBFT_NODE_PROFILE=<dir>`` cProfiles the whole node process and
    dumps pstats to ``<dir>/node-<id>.pstats`` on clean shutdown — the
    only way to see where a REAL (multi-process, socket-driven) node
    spends CPU, since in-process profiles skew the event-loop/syscall
    mix.
    """
    # The consensus hot path allocates heavily (Steps, frozen message
    # dataclasses, frames) but makes almost no reference cycles; the
    # default gen-0 threshold (700) makes the collector scan thousands of
    # times per second for nothing.  Raise the thresholds rather than
    # disable: asyncio does create cycles (Task exception contexts), so
    # collection must still happen, just orders of magnitude less often.
    import gc
    gc.set_threshold(50_000, 25, 25)
    profile_dir = os.environ.get("HBBFT_NODE_PROFILE", "")
    profiler = None
    if profile_dir:
        import cProfile
        # CPU-time timer: with several node processes sharing cores, the
        # default wall timer books preemption gaps onto whatever call was
        # live, swamping the real hot spots
        profiler = cProfile.Profile(time.process_time)
        profiler.enable()
    infos = generate_infos(cfg)
    rt = build_runtime(cfg, infos, nid)
    try:
        host, port = cfg.addr(nid)
        await rt.start(host, port)
        if metrics_port:
            m_host, m_port = await rt.start_obs(host, metrics_port)
            print(f"node {nid} obs endpoint on http://{m_host}:{m_port}"
                  f"/metrics", flush=True)
        rt.connect(cfg.addr_map())
        print(f"node {nid} listening on {host}:{port}", flush=True)
        await _serve_runtime(rt)
    except BaseException as exc:
        # crash-dump flush: make the black box land on disk before the
        # process dies, whatever killed it
        rt.flight_crash(exc)
        raise
    finally:
        if profiler is not None:
            profiler.disable()
            os.makedirs(profile_dir, exist_ok=True)
            profiler.dump_stats(
                os.path.join(profile_dir, f"node-{nid}.pstats"))
        timing_dir = os.environ.get("HBBFT_PUMP_TIMING", "")
        if timing_dir and rt._pump_timing:
            os.makedirs(timing_dir, exist_ok=True)
            # hblint: disable=async-blocking-call (one-shot perf-diagnosis
            # dump on the shutdown path; nothing is being served anymore)
            with open(os.path.join(timing_dir, f"node-{nid}.json"),
                      "w") as fh:
                json.dump({"timing": rt._pump_timing,
                           "batches": len(rt.batches),
                           "iterations": rt.pump.iterations}, fh)
    await rt.stop()


def warm_device(cfg: ClusterConfig) -> None:
    """Before a node process serves on a CUDA device: create the context,
    load every kernel library and, under the ``device`` erasure backend, run
    one erasure product with the node's coder.  PyTorch loads its CUDA
    kernels at their first use; left to the first product under load, with
    many node processes starting on one card, that took seconds, all of them
    spent by the pump thread while the node's event loop waited."""
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.ops import rs

    torch.empty(1, device=cfg.device)
    for name in _build.KERNELS:
        _build.lib(name)
    if rs.resolve_backend() == "device":
        coder = rs.for_n_f(cfg.n, (cfg.n - 1) // 3)
        zeros = np.zeros((coder.data_shards, 2), dtype=np.uint8)
        coder._apply_matrix(("parity",), coder.parity_matrix, zeros, device=cfg.device)
    torch.cuda.synchronize(cfg.device)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(
        description="run ONE hbbft-tpu cluster node of the PyTorch port"
    )
    ap.add_argument("--nodes", type=int, required=True)
    ap.add_argument("--node-id", type=int, required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--base-port", type=int, required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-tx-bytes", type=int, default=0,
                    help="per-tx admission ceiling in bytes "
                         "(0 = Mempool default, 256 KiB)")
    ap.add_argument("--encrypt", action="store_true")
    ap.add_argument("--vid", action="store_true",
                    help="verifiable information dispersal: order "
                         "constant-size (root, cert) commitments and "
                         "retrieve payloads lazily post-commit")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve /metrics /status /spans /flight on this "
                         "port (0 = off)")
    ap.add_argument("--flight-dir", default="",
                    help="flight-recorder journal ROOT (this node "
                         "journals to <dir>/node-<id>; empty = off)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="epochs kept in flight at once (1 = sequential)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the node's device work (default "
                         "cuda; raises without a card — pass cpu to run "
                         "the plain PyTorch versions)")
    ap.add_argument("--heartbeat-s", type=float, default=0.5,
                    help="seconds between pings on an idle peer link")
    ap.add_argument("--dead-after-s", type=float, default=3.0,
                    help="silence after which a peer link is declared "
                         "dead and redialed (also the handshake's wait)")
    ap.add_argument("--link-delays", default="",
                    help="outbound link shaping, SRC>DST:SECONDS[,…] "
                         "(only entries whose SRC is this node apply)")
    ap.add_argument("--chaos", default="",
                    help="named chaos link-shaping preset (wan-100ms, "
                         "lossy-1pct, dup-reorder, partition-10s, "
                         "bandwidth-64k); empty = off")
    ap.add_argument("--chaos-seed", type=int, default=-1,
                    help="seed for the chaos fault RNGs "
                         "(-1 = the cluster seed)")
    ap.add_argument("--step-delay", type=float, default=0.0,
                    help="sleep SECONDS before every pump iteration "
                         "(slow-node chaos shaping)")
    ap.add_argument("--aba-out-delay", type=float, default=0.0,
                    help="hold THIS node's outbound binary-agreement "
                         "traffic for SECONDS (class-selective shaping)")
    ap.add_argument("--aba-out-classes", default="",
                    help="narrow --aba-out-delay to these phase classes "
                         "(comma list, e.g. aba_conf); empty = all aba_*")
    ap.add_argument("--ingress-workers", action="store_true",
                    help="decode inbound peer frames on per-peer worker "
                         "threads instead of the event loop "
                         "(net/ingress.py)")
    ap.add_argument("--no-auth", action="store_true",
                    help="disable the authenticated node handshake "
                         "(identification-only hellos — trusted "
                         "fabrics only)")
    ap.add_argument("--auth-grace-s", type=float, default=30.0,
                    help="previous-era key grace window during DKG "
                         "rotations, seconds")
    ap.add_argument("--no-degrade", action="store_true",
                    help="disable guard-driven adaptive degradation "
                         "(batch-size/mempool shrink under sustained "
                         "overload)")
    ap.add_argument("--max-boost", type=int, default=0,
                    help="arm the controller's raise side: up to this "
                         "many batch-size/mempool doublings under "
                         "sustained measured headroom (0 = degrade-"
                         "only ladder)")
    ap.add_argument("--raise-windows", type=int, default=10,
                    help="clean windows of slack+demand per boost step "
                         "(with --max-boost)")
    ap.add_argument("--raise-headroom", type=float, default=0.6,
                    help="measured headroom floor that counts as slack "
                         "(with --max-boost)")
    ap.add_argument("--join", action="store_true",
                    help="join a LIVE cluster via snapshot state-sync "
                         "instead of starting from genesis: the "
                         "existing validators must already have voted "
                         "this node id in (DKG rotation complete); "
                         "--node-id may exceed --nodes-1 for a brand-"
                         "new validator")
    args = ap.parse_args(argv)
    if args.join:
        if args.node_id < 0:
            ap.error(f"--node-id {args.node_id} must be >= 0")
    elif not 0 <= args.node_id < args.nodes:
        ap.error(f"--node-id {args.node_id} not in 0..{args.nodes - 1}")
    cfg = ClusterConfig(
        n=args.nodes, seed=args.seed, base_port=args.base_port,
        batch_size=args.batch_size, max_tx_bytes=args.max_tx_bytes,
        encrypt=args.encrypt, vid=args.vid,
        heartbeat_s=args.heartbeat_s, dead_after_s=args.dead_after_s,
        flight_dir=args.flight_dir, pipeline_depth=args.pipeline_depth,
        link_delays=args.link_delays,
        chaos=args.chaos, chaos_seed=args.chaos_seed,
        slow_node=(args.node_id if args.step_delay > 0 else -1),
        slow_delay_s=args.step_delay,
        aba_delay_nodes=(str(args.node_id) if args.aba_out_delay > 0
                         else ""),
        aba_out_delay_s=args.aba_out_delay,
        aba_out_classes=args.aba_out_classes,
        ingress_workers=args.ingress_workers,
        auth=not args.no_auth,
        auth_grace_s=args.auth_grace_s,
        degrade=not args.no_degrade,
        max_boost=args.max_boost,
        raise_windows=args.raise_windows,
        raise_headroom=args.raise_headroom,
        device=args.device,
    )
    if resolve_device(cfg.device).type == "cuda":
        warm_device(cfg)
    if args.join:
        asyncio.run(run_join_node(cfg, args.node_id,
                                  metrics_port=args.metrics_port))
    else:
        asyncio.run(run_node(cfg, args.node_id,
                             metrics_port=args.metrics_port))


if __name__ == "__main__":
    main()
