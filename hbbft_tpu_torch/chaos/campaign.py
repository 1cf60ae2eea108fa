"""Chaos campaign runner: seeded scenario sweeps judged by the auditor.

``python -m hbbft_tpu_torch.chaos.campaign`` runs a grid of seeded
(link-shaping policy × topology × adversary) **cells**.  Each simulator
cell is one deterministic VirtualNet run of the full QHB stack with

- a :mod:`hbbft_tpu_torch.chaos.link` preset (scaled to the virtual clock)
  shaping every directed edge,
- one adversary from the zoo (:mod:`hbbft_tpu_torch.sim.adversary`),
- a flight recorder per node (logical clock → byte-deterministic
  journals),

after which the cell's journal set is fed to the forensic auditor
(:mod:`hbbft_tpu_torch.obs.audit`).  Churn cells run a real in-process socket
cluster (:class:`~hbbft_tpu_torch.net.cluster.LocalCluster`) through a
kill/restart storm instead, and audit the incident's journals the same
way.

Every non-clean verdict is **auto-triaged**: the report names the faulty
node(s), the first divergent epoch, and carries the exact
:class:`CellSpec` (seed included) needed to replay the cell — a
simulator cell replays **byte-identically** (``--replay`` checks this by
running the spec twice and comparing merged audit timelines).

Output is ONE JSON report (verdict histogram, liveness/latency per cell,
shaping counters, triage list; ``unit: clean_fraction``).

Every cell's device work (the threshold-decrypt share-set folds, the
erasure products under ``HBBFT_ERASURE_BACKEND=device``) runs on the
``device`` argument of the runners and the CLI's ``--device`` (default
``"cuda"``, raising without a card; ``"cpu"`` runs the kernels' plain
PyTorch versions).  The device is not part of a :class:`CellSpec`: a spec
replays the same on either.

No wall-clock reads (but the socket scenario's measured liveness), no
unseeded randomness — campaign runs are replayable artifacts, not weather
reports.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import sys
from dataclasses import asdict, dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.chaos.link import PRESETS, preset_shape
from hbbft_tpu_torch.obs import critpath as _critpath
from hbbft_tpu_torch.obs.audit import AuditResult, run_audit
from hbbft_tpu_torch.obs.audit_stream import (
    IncrementalAuditor,
    JournalTailer,
    extract_incidents,
)
from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
from hbbft_tpu_torch.protocols.queueing_honey_badger import (
    QhbBatch,
    QueueingHoneyBadger,
    TxInput,
)
from hbbft_tpu_torch.sim import NetBuilder
from hbbft_tpu_torch.sim.adversary import (
    CensorshipAdversary,
    CrashAtEpochAdversary,
    EclipseAdversary,
    EquivocatingAdversary,
    FloodAdversary,
    FutureEpochSpamAdversary,
    GarbageStreamAdversary,
    IdentitySpoofAdversary,
    MitmDelayAdversary,
    NullAdversary,
    ReorderingAdversary,
    SpoofReplayAdversary,
    VoteStormAdversary,
)
from hbbft_tpu_torch.sim.trace import CostModel

#: keygen seed shared by every cell — BLS key material is NOT the chaos
#: variable, and regenerating it per cell would dominate the sweep
KEYGEN_SEED = 13

_INFOS: Dict[int, Dict[int, Any]] = {}


def _infos_for(n: int):
    if n not in _INFOS:
        from hbbft_tpu_torch.netinfo import NetworkInfo

        _INFOS[n] = NetworkInfo.generate_map(
            list(range(n)), random.Random(KEYGEN_SEED))
    return _INFOS[n]


# ===========================================================================
# Cell specification — the replay artifact
# ===========================================================================


@dataclass(frozen=True)
class CellSpec:
    """Everything needed to replay one campaign cell deterministically."""

    shape: str = "none"          # chaos.link preset name
    adversary: str = "null"      # zoo name (see ADVERSARIES)
    n: int = 4
    batch_size: int = 4
    txs: int = 8
    seed: int = 0                # drives protocol RNGs, shaping, adversary
    time_scale: float = 1e-3     # preset times × this (virtual seconds)
    crank_limit: int = 40_000
    kind: str = "sim"            # "sim" | "churn" | "socket"
    restarts: int = 2            # churn cells: kill/restart count
    pipeline_depth: int = 1      # socket cells: epochs kept in flight
    vid: bool = False            # socket cells: order VID commitments,
    #                              retrieve payloads lazily (net/retrieve)

    @property
    def name(self) -> str:
        return (f"{self.kind}--{self.shape}--{self.adversary}"
                f"--n{self.n}--s{self.seed}"
                + ("--vid" if self.vid else ""))

    @property
    def faulty(self) -> Tuple[int, ...]:
        """Byzantine node set implied by the adversary (the equivocator
        needs a faulty sender for tamper() to apply to; the flood /
        window-spam adversaries act under the last node's identity).
        Spoof adversaries return (): their victim genuinely sent the
        replayed traffic once and must NOT be pre-blamed — mis-blaming
        the impersonated node is exactly the failure those cells
        exist to catch."""
        if self.adversary in ("equivocate", "flood", "future-spam"):
            return (self.n - 1,)
        return ()

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "CellSpec":
        return cls(**{k: doc[k] for k in cls.__dataclass_fields__
                      if k in doc})


#: the adversary zoo, by campaign name.  "flood" and "future-spam" are
#: the overload-defense drills (valid-frame spam amplification and
#: window-edge protocol spam); "spoof-replay" is the identity-theft
#: analog the authenticated transport leaves possible in-sim (replayed
#: duplicates of an HONEST victim's own traffic — the victim must not
#: be blamed).  Their socket siblings ("garbage-stream" / "flood" /
#: the "spoof-*" modes at kind "socket") drive a REAL cluster via
#: raw-socket injectors instead of the simulator hooks.
ADVERSARIES: Tuple[str, ...] = (
    "null", "reorder", "mitm-delay", "censor-ready", "eclipse", "crash",
    "equivocate", "vote-storm", "flood", "future-spam", "spoof-replay",
)

#: per-preset sim time scale: presets are written in real seconds, cells
#: run on the cost model's much faster virtual clock — each preset is
#: scaled so its faults actually bite within a short run (wan latency
#: comparable to an epoch; the partition window opening mid-run)
SIM_SCALES: Dict[str, float] = {
    "none": 1e-3,
    "wan-100ms": 5e-3,
    "lossy-1pct": 1e-3,
    "dup-reorder": 1e-3,
    "partition-10s": 5e-4,
    "bandwidth-64k": 1e-3,
}


def make_adversary(spec: CellSpec):
    """Build the cell's adversary, parameterized from the scenario seed
    (every budget/trigger derives from ``spec.seed`` so cells sweep the
    adversary's strength, not just its schedule)."""
    name, seed, n = spec.adversary, spec.seed, spec.n
    if name == "null":
        return NullAdversary()
    if name == "reorder":
        return ReorderingAdversary(seed=seed)
    if name == "mitm-delay":
        # seeded delay budget (satellite: max_delay=None draws from seed)
        return MitmDelayAdversary(target=0, max_delay=None, seed=seed)
    if name == "censor-ready":
        return CensorshipAdversary(msg_types=("ReadyMsg",), dests=(1,),
                                   seed=seed)
    if name == "eclipse":
        return EclipseAdversary(victim=n - 1,
                                heal_crank=1500 + (seed % 4) * 700)
    if name == "crash":
        return CrashAtEpochAdversary(victim=n - 1,
                                     after_batches=1 + seed % 2)
    if name == "equivocate":
        return EquivocatingAdversary()
    if name == "vote-storm":
        # membership-vote storms: coordinated remove/re-add waves drive
        # REAL DKG rotations mid-run (mid-partition under the
        # partition-10s preset); split waves stall without a winner
        return VoteStormAdversary(seed=seed)
    if name == "flood":
        # max-rate valid-frame spam amplification from the last node
        return FloodAdversary(flooder=n - 1, seed=seed)
    if name == "future-spam":
        # window-edge protocol spam: the receivers' future-epoch
        # budgets and buffer caps must absorb it, counted
        return FutureEpochSpamAdversary(spammer=n - 1, seed=seed)
    if name == "spoof-replay":
        # replayed duplicates of node 0's own genuine traffic: the
        # strongest spoof the authenticated transport leaves possible.
        # Duplicates are protocol no-ops; node 0 stays HONEST (not in
        # spec.faulty) and the cell must audit clean
        return SpoofReplayAdversary(victim=0, seed=seed)
    raise ValueError(f"unknown adversary {name!r} "
                     f"(known: {', '.join(ADVERSARIES)})")


# ===========================================================================
# Simulator cells
# ===========================================================================


def _qhb_stack(infos, nid, spec: CellSpec, device="cuda"):
    return QueueingHoneyBadger(
        DynamicHoneyBadger(
            infos[nid], infos[nid].secret_key(),
            rng=random.Random(spec.seed * 1_000 + 100 + nid),
            encryption_schedule=EncryptionSchedule.never(),
            device=device,
        ),
        batch_size=spec.batch_size,
        rng=random.Random(spec.seed * 1_000 + 500 + nid),
    )


def _timeline_digest(res: AuditResult) -> str:
    """Digest of the merged audit timeline — the byte-identity witness
    two replays of one spec must share."""
    h = hashlib.sha3_256()
    for e in res.events:
        h.update(e.line.encode())
        h.update(b"\n")
    return h.hexdigest()[:24]


def _sim_guard_doc(net, correct) -> Dict[str, Any]:
    """Per-cell overload-defense witness for simulator cells: every
    budgeted buffer's RUN-LONG peak depth vs its cap across the correct
    nodes, plus the counted drops/evictions.  Peaks/evictions of epochs
    that CLOSED during the run are preserved (``HoneyBadger`` folds
    them into ``closed_guard`` when it deletes the epoch state) and
    merged with the live instances' high-water marks, so the witness
    covers the whole run, not just whatever was still open at the end.
    The flood cells assert the peaks stay ≤ the caps (+1: peaks record
    the pre-eviction length, falsifiably) while the cluster commits."""
    aba_peak = aba_cap = 0
    aba_evictions = 0
    hb_drops = 0
    subset_drops = 0
    era_drops = 0
    for nid in correct:
        algo = net.nodes[nid].algorithm
        algo = getattr(algo, "algo", algo)            # unwrap SenderQueue
        dhb = getattr(algo, "dhb", algo)
        hb = getattr(dhb, "hb", dhb)
        era_drops += sum(getattr(dhb, "future_era_drops", {}).values())
        hb_drops += sum(getattr(hb, "future_drops", {}).values())
        closed = getattr(hb, "closed_guard", {})
        aba_peak = max(aba_peak, closed.get("aba_future_peak", 0))
        aba_evictions += closed.get("aba_future_evictions", 0)
        subset_drops += closed.get("subset_flood_drops", 0)
        for state in getattr(hb, "epochs", {}).values():
            subset_drops += sum(state.subset.flood_drops.values())
            for prop in state.subset.proposals.values():
                ba = prop.agreement
                aba_cap = max(aba_cap, ba.future_cap_per_sender)
                aba_peak = max(aba_peak, ba.future_peak)
                aba_evictions += sum(ba.future_evictions.values())
    if aba_peak and not aba_cap:
        # every live BA closed before the read: report the default cap
        # so the folded peak still has its bound to compare against
        from hbbft_tpu_torch.protocols.binary_agreement import (
            DEFAULT_MAX_FUTURE_EPOCHS, FUTURE_CAP_PER_EPOCH,
        )

        aba_cap = FUTURE_CAP_PER_EPOCH * (DEFAULT_MAX_FUTURE_EPOCHS + 1)
    return {
        "aba_future_peak": aba_peak,
        "aba_future_cap": aba_cap,
        "aba_future_evictions": aba_evictions,
        "hb_future_drops": hb_drops,
        "subset_flood_drops": subset_drops,
        "future_era_drops": era_drops,
    }


def _cell_critpath(cell_dir: str) -> Optional[Dict[str, Any]]:
    """Per-cell latency attribution: the critical-path summary over the
    cell's journals (obs.critpath) — a shaped link (e.g. ``wan-100ms``)
    must surface as ``wire`` time in the decomposition, not as a
    mysteriously slow protocol phase."""
    dirs = _critpath.find_journal_dirs(cell_dir)
    if not dirs:
        return None
    rep = _critpath.build_report(sorted(dirs), waterfalls=0)
    return {
        "reconstructed_fraction": rep["reconstructed_fraction"],
        "mean_components": rep["mean_components"],
        "p50": rep.get("p50"),
        "dominant": (rep.get("p50") or {}).get("dominant"),
        "unmatched": rep["unmatched"],
    }


#: crank period between streaming-audit polls in simulator cells: the
#: online detector's tick.  The recorder flushes every append, so each
#: poll sees all evidence journaled up to that crank.  Fine-grained on
#: purpose: a quiet unshaped cell can go quiescent inside a few hundred
#: cranks, and the online-detection claim needs polls DURING the run.
#: Cheap by construction — the tailer read is incremental, and the
#: result() derivation only runs while a configured-faulty cell is
#: still undetected (clean cells never derive mid-run).
WATCH_POLL_CRANKS = 200


def _watch_online(tailer: JournalTailer, faulty: frozenset,
                  watch: Dict[str, Any], virtual_s: float,
                  cranks: int) -> None:
    """One online-detection check: did the streaming auditor just raise
    an incident naming a configured-faulty node?  First hit stamps the
    detection time (the cell's virtual clock — the online-detection
    latency of :func:`build_obs_report`)."""
    if watch["detected_online"] or not faulty:
        return
    for fi in extract_incidents(tailer.result()):
        if fi["subject"] in faulty:
            watch["detected_online"] = True
            watch["detect_virtual_s"] = round(virtual_s, 6)
            watch["detect_cranks"] = cranks
            watch["first_kind"] = fi["kind"]
            return


def run_cell(spec: CellSpec, cell_dir: str, device="cuda"
             ) -> Tuple[Dict[str, Any], AuditResult]:
    """One simulator cell on ``device``: run, record, audit.  Returns the
    per-cell report dict and the audit result.

    The streaming auditor rides along: a :class:`JournalTailer` polls
    the cell's journals every ``WATCH_POLL_CRANKS`` cranks DURING the
    run (the watchtower's sim-cell stand-in — virtual clock, no
    sockets), so a Byzantine cell's report carries whether the fault
    was flagged online and at what virtual-time latency."""
    infos = _infos_for(spec.n)
    builder = (
        NetBuilder(list(range(spec.n)))
        .adversary(make_adversary(spec))
        .faulty(list(spec.faulty))
        .cost_model(CostModel())
        .flight(cell_dir)
    )
    if spec.shape not in ("", "none"):
        builder.shape(preset_shape(spec.shape, spec.n)
                      .scaled(spec.time_scale), seed=spec.seed)
    net = builder.using_step(lambda nid: _qhb_stack(infos, nid, spec, device))
    for i in range(spec.txs):
        net.send_input(i % spec.n, TxInput(b"chaos-%04d" % i))
    tailer = JournalTailer([cell_dir], IncrementalAuditor(max_events=0))
    faulty_names = frozenset(str(nid) for nid in spec.faulty)
    watch: Dict[str, Any] = {
        "detected_online": False, "detect_virtual_s": None,
        "detect_cranks": None, "first_kind": None, "incidents": [],
    }
    while net.cranks < spec.crank_limit:
        if net.crank() is None:
            break
        if net.cranks % WATCH_POLL_CRANKS == 0:
            tailer.poll()
            _watch_online(tailer, faulty_names, watch,
                          net.virtual_time, net.cranks)
    net.close_observers()
    # boundary poll: evidence flushed at close still counts, but is NOT
    # online detection (the cell had already ended)
    tailer.finalize()
    watch["incidents"] = sorted(
        {(fi["kind"], fi["subject"])
         for fi in extract_incidents(tailer.result())})
    res, _journals = run_audit([cell_dir])
    correct = [nid for nid in range(spec.n) if nid not in spec.faulty]
    batches = {
        nid: sum(1 for o in net.nodes[nid].outputs
                 if isinstance(o, QhbBatch))
        for nid in correct
    }
    min_b = min(batches.values())
    eras = max(
        (o.era for nid in correct for o in net.nodes[nid].outputs
         if isinstance(o, QhbBatch)), default=0)
    detail = {
        "cell": spec.name,
        "spec": spec.as_dict(),
        "verdict": res.verdict,
        "batches_min": min_b,
        "batches_max": max(batches.values()),
        "eras_rotated": eras,
        "stalled": min_b == 0,
        "cranks": net.cranks,
        "virtual_time_s": round(net.virtual_time, 6),
        "epoch_virtual_s": (round(net.virtual_time / min_b, 6)
                            if min_b else None),
        "shaping": net.shaper.stats() if net.shaper is not None else None,
        "adversary_filtered": net.adversary_filtered,
        "timeline_digest": _timeline_digest(res),
        "guard": _sim_guard_doc(net, correct),
        "overload_attributed_to": [
            o["peer"] for o in res.overload_incidents
        ],
        "watch": watch,
        "critical_path": _cell_critpath(cell_dir),
        "journal": cell_dir,
    }
    return detail, res


def replay_matches(spec: CellSpec, expected_digest: str,
                   scratch_dir: str, device="cuda") -> bool:
    """Re-run ``spec`` into ``scratch_dir``; True iff the merged audit
    timeline is byte-identical to the recorded digest."""
    detail, _res = run_cell(spec, scratch_dir, device)
    return detail["timeline_digest"] == expected_digest


# ===========================================================================
# Churn cells (socket cluster kill/restart storms)
# ===========================================================================


async def _churn_scenario(spec: CellSpec, cell_dir: str,
                          device="cuda") -> Dict[str, Any]:
    import asyncio

    from hbbft_tpu_torch.net.cluster import (
        ClusterConfig,
        LocalCluster,
        find_free_base_port,
    )

    cfg = ClusterConfig(
        n=spec.n, seed=spec.seed, batch_size=spec.batch_size,
        base_port=find_free_base_port(spec.n),
        heartbeat_s=0.2, dead_after_s=1.5,
        flight_dir=cell_dir,
        chaos=spec.shape if spec.shape != "none" else "",
        chaos_seed=spec.seed,
        device=device,
    )
    cluster = LocalCluster(cfg)
    await cluster.start()
    wave = 0
    try:
        client = await cluster.client(0)

        async def pump(count: int) -> None:
            nonlocal wave
            txs = [b"churn-%02d-%04d" % (wave, i) for i in range(count)]
            wave += 1
            for tx in txs:
                status = await client.submit(tx)
                if status != 0:
                    raise AssertionError(
                        f"churn cell tx rejected with status {status}")
            for tx in txs:
                await client.wait_committed(tx, timeout_s=60)

        await pump(spec.batch_size * 2)
        rng = random.Random(spec.seed * 7 + 3)
        victims = [rng.randrange(1, spec.n) for _ in range(spec.restarts)]
        for victim in victims:
            await cluster.restart_node(victim)
            await pump(spec.batch_size * 2)
        # every node (restarted ones included) must converge on a common
        # chain prefix — a wedged catch-up fails loudly here
        await cluster.wait_epochs(min_batches=2, timeout_s=60)
        prefix = cluster.common_digest_prefix()
        batches = [len(rt.batches) for rt in cluster.runtimes]
        return {
            "batches_min": min(batches),
            "batches_max": max(batches),
            "victims": victims,
            "common_prefix_len": len(prefix),
        }
    finally:
        await cluster.stop()


def run_churn_cell(spec: CellSpec, cell_dir: str, device="cuda"
                   ) -> Tuple[Dict[str, Any], AuditResult]:
    import asyncio

    live = asyncio.run(asyncio.wait_for(
        _churn_scenario(spec, cell_dir, device), 180))
    res, _journals = run_audit([cell_dir])
    detail = {
        "cell": spec.name,
        "spec": spec.as_dict(),
        "verdict": res.verdict,
        "batches_min": live["batches_min"],
        "batches_max": live["batches_max"],
        "stalled": live["batches_min"] == 0,
        "restarts": dict(res.restarts),
        "victims": live["victims"],
        "common_prefix_len": live["common_prefix_len"],
        "journal": cell_dir,
    }
    return detail, res


# ===========================================================================
# Socket cells (WAN-shaped PIPELINED cluster liveness)
# ===========================================================================


#: socket-kind adversaries driven by raw-socket injectors (everything
#: else in the zoo is a simulator adversary).  The flood injectors
#: model a COMPROMISED validator (they hold its real key, so the
#: authenticated handshake completes and the flood drill proceeds);
#: the spoof injectors claim a correct validator's id WITHOUT its key
#: and must be refused at the challenge, zero frames in.
SOCKET_FLOOD_ADVERSARIES = ("garbage-stream", "flood")
SOCKET_SPOOF_ADVERSARIES = ("spoof-nokey", "spoof-wrongkey",
                            "spoof-hijack", "spoof-downgrade")


async def _socket_scenario(spec: CellSpec, cell_dir: str,
                           device="cuda") -> Dict[str, Any]:
    """A real socket cluster at ``pipeline_depth > 1`` under a chaos
    preset at its REAL timings (wan latency in actual milliseconds):
    traffic must keep committing and the whole incident must audit
    clean — the pipelined liveness point of the chaos trajectory.

    With a flood adversary (``garbage-stream`` / ``flood``), a
    raw-socket injector holding the LAST validator's REAL key (the
    compromised-validator model) floods node 0 while the cell's client
    traffic flows: the cluster must keep committing, every budgeted
    buffer gauge must stay under its cap (sampled live throughout the
    flood), and the guard's counted throttles/disconnects must
    attribute the incident to the claimed identity in the audit.

    With a spoof adversary (``spoof-*``), the injector claims the last
    validator's identity WITHOUT its key: every hello must be refused
    at the challenge (zero accepted, counted under
    ``hbbft_guard_auth_failures_total``), the impersonated validator
    must accrue no budget debt or strikes, and the audit must name the
    ATTACKER's endpoint — never the victim — in its incidents."""
    import asyncio
    import contextlib
    import time

    from hbbft_tpu_torch.net.cluster import (
        ClusterConfig,
        LocalCluster,
        find_free_base_port,
        node_secret_key,
    )

    flooding = spec.adversary in SOCKET_FLOOD_ADVERSARIES
    spoofing = spec.adversary in SOCKET_SPOOF_ADVERSARIES
    cfg = ClusterConfig(
        n=spec.n, seed=spec.seed, batch_size=spec.batch_size,
        base_port=find_free_base_port(spec.n),
        heartbeat_s=0.3, dead_after_s=3.0,
        flight_dir=cell_dir,
        pipeline_depth=spec.pipeline_depth,
        vid=spec.vid,
        chaos=spec.shape if spec.shape != "none" else "",
        chaos_seed=spec.seed,
        # flood cells tighten the ingress budgets so the guard engages
        # within the cell's few-second window (production defaults are
        # sized for sustained heavy traffic, not a short drill)
        ingress_bytes_per_s=256 * 1024 if flooding else 0,
        ingress_burst_bytes=128 * 1024 if flooding else 0,
        ingress_decode_strikes=64 if flooding else 0,
        ingress_throttle_strikes=8 if flooding else 0,
        device=device,
    )
    cluster = LocalCluster(cfg)
    await cluster.start()
    injector = None
    injector_task = None
    gauge_peaks = {"senderq_buffered": 0, "inflight_frames": 0}
    caps = {"senderq_buffered": None, "inflight_frames": None}
    stop_sampling = asyncio.Event()

    async def sample_gauges():
        """Live witness that every budgeted buffer stays ≤ its cap for
        the WHOLE run, not just at the end.  Reads only thread-safe
        surfaces: the SenderQueue's own post-cap high-water mark (an
        int maintained on the pump thread — iterating the live backlog
        lists from this loop would race their mutations) and the
        ingress budget's lock-protected peer table."""
        while not stop_sampling.is_set():
            for rt in cluster.runtimes:
                sq = rt.sq
                # the ASSERTABLE bounds: peaks are recorded pre-chop
                # (+1 transient is legal) and the in-flight cap is
                # enforced at recv-chunk granularity
                caps["senderq_buffered"] = sq.buffered_cap + 1
                caps["inflight_frames"] = (
                    rt.transport.ingress.inflight_hard_bound)
                gauge_peaks["senderq_buffered"] = max(
                    gauge_peaks["senderq_buffered"], sq.buffered_peak)
                for doc in rt.transport.ingress.peer_doc().values():
                    gauge_peaks["inflight_frames"] = max(
                        gauge_peaks["inflight_frames"], doc["inflight"])
            with contextlib.suppress(asyncio.TimeoutError):
                await asyncio.wait_for(stop_sampling.wait(), 0.1)

    sampler = None
    tower = None
    watcher = None
    try:
        if flooding:
            # the flood injector holds the claimed validator's REAL
            # key (compromised-validator model): the authenticated
            # handshake completes and the ingress-budget drill runs
            # exactly as before auth existed
            injector = GarbageStreamAdversary(
                seed=spec.seed,
                valid_frames=(spec.adversary == "flood"),
                secret_key=node_secret_key(cfg, spec.n - 1))
            injector_task = asyncio.ensure_future(injector.run(
                cluster.addrs[0], cfg.cluster_id, identity=spec.n - 1,
                duration_s=20.0))
        elif spoofing:
            mode = spec.adversary[len("spoof-"):]
            # wrongkey/downgrade sign the genuine transcript with a key
            # that is NOT the claimed validator's — deterministically
            # derived, guaranteed outside the cluster's key map
            from hbbft_tpu_torch.crypto import tc
            wrong = (tc.SecretKey.random(
                random.Random(spec.seed * 7919 + 123))
                if mode in ("wrongkey", "downgrade") else None)
            # the downgrade probe claims a NON-current era (the cell
            # never rotates, so any era != 0 drives the stale-era /
            # mismatch verification path the grace window gates)
            injector = IdentitySpoofAdversary(
                seed=spec.seed, mode=mode, secret_key=wrong,
                claim_era=3 if mode == "downgrade" else 0)
            injector_task = asyncio.ensure_future(injector.run(
                cluster.addrs[0], cfg.cluster_id, identity=spec.n - 1,
                duration_s=8.0))
        # the live watchtower: scrape every node's obs endpoint AND tail
        # the cell's journals through the streaming auditor while the
        # scenario runs — online detection on a REAL cluster, wall-clock
        # latency measured from scenario start
        from hbbft_tpu_torch.obs.watch import Watchtower

        tower = Watchtower(
            [cluster.metrics_addrs[nid] for nid in range(spec.n)],
            journal_roots=[cell_dir], scrape_timeout_s=1.0)
        faulty_names = frozenset(str(nid) for nid in spec.faulty)
        watch_doc: Dict[str, Any] = {
            "detected_online": False, "detect_wall_s": None,
            "first_kind": None, "incidents": [],
        }
        loop = asyncio.get_event_loop()
        # hblint: disable=det-wall-clock (live watchtower over a
        # real-time cluster: wall clock IS the measured detection
        # latency, same clock as the cell's liveness measurement)
        watch_t0 = time.monotonic()

        async def watch_loop():
            while not stop_sampling.is_set():
                # hblint: disable=det-wall-clock (same measured clock)
                now = time.monotonic()
                new = await loop.run_in_executor(None, tower.tick, now)
                for inc in new:
                    if (not watch_doc["detected_online"]
                            and inc["subject"] in faulty_names):
                        watch_doc["detected_online"] = True
                        watch_doc["detect_wall_s"] = round(
                            now - watch_t0, 3)
                        watch_doc["first_kind"] = inc["kind"]
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(stop_sampling.wait(), 0.5)

        watcher = asyncio.ensure_future(watch_loop())
        sampler = asyncio.ensure_future(sample_gauges())
        client = await cluster.client(
            0, trace_dir=os.path.join(cell_dir, "client-0"))
        txs = [b"sock-%04d" % i for i in range(spec.txs)]
        # hblint: disable=det-wall-clock (socket cells run a REAL-time
        # cluster under real-second chaos presets: wall time here is the
        # measured liveness metric, not replica logic — sim cells stay
        # on the virtual clock)
        t0 = time.monotonic()
        for tx in txs:
            status = await client.submit(tx)
            if status != 0:
                raise AssertionError(
                    f"socket cell tx rejected with status {status}")
        for tx in txs:
            await client.wait_committed(tx, timeout_s=120)
        # hblint: disable=det-wall-clock (same measured-liveness read)
        wall = time.monotonic() - t0
        await cluster.wait_epochs(min_batches=1, timeout_s=60)
        if injector_task is not None:
            if flooding:
                injector.budget_frames = 0  # stop flooding, then join
            else:
                injector.budget_attempts = 0
            await asyncio.wait_for(injector_task, 30.0)
            injector_task = None
        prefix = cluster.common_digest_prefix()
        batches = [len(rt.batches) for rt in cluster.runtimes]
        stop_sampling.set()
        await sampler
        await watcher
        # boundary poll: evidence flushed at teardown still lands in the
        # incident list, but detect_wall_s only ever records ONLINE hits
        tower.tailer.finalize()
        for fi in extract_incidents(tower.tailer.result()):
            tower.incidents.append(
                {"kind": fi["kind"], "severity": fi["severity"],
                 "subject": fi["subject"]})
        watch_doc["incidents"] = sorted(
            {(i["kind"], i["subject"]) for i in tower.incidents})
        out = {
            "batches_min": min(batches),
            "batches_max": max(batches),
            "commit_wall_s": round(wall, 3),
            "common_prefix_len": len(prefix),
            "watch": watch_doc,
        }
        if flooding:
            guard_docs = [rt.transport.ingress.as_dict()
                          for rt in cluster.runtimes]
            out["guard"] = {
                "gauge_peaks": gauge_peaks,
                "gauge_caps": caps,
                "throttles": sum(g["throttles"] for g in guard_docs),
                "disconnects": sum(g["disconnects"]
                                   for g in guard_docs),
                "decode_strikes": sum(g["decode_strikes"]
                                      for g in guard_docs),
                "hello_rejects": sum(g["hello_rejects"]
                                     for g in guard_docs),
                "injector": {
                    "frames_sent": injector.frames_sent,
                    "bytes_sent": injector.bytes_sent,
                    "disconnects_observed": injector.disconnects,
                },
            }
        elif spoofing:
            victim_ingress = cluster.runtimes[0].transport.ingress
            doc = victim_ingress.as_dict()
            auth_refused = sum(doc["auth_failures"].values())
            # the spoof-proof contract, asserted live: zero spoofed
            # hellos accepted, every attempt refused AND counted, and
            # the IMPERSONATED validator's budget record stays
            # strike-free (its genuine peer connection keeps working)
            if injector.hellos_accepted:
                raise AssertionError(
                    f"spoofed hello ACCEPTED "
                    f"({injector.hellos_accepted} of "
                    f"{injector.attempts} attempts)")
            if injector.attempts and not auth_refused:
                raise AssertionError(
                    "spoof attempts were made but no auth failure "
                    "was counted")
            victim_peer = doc["peers"].get(repr(spec.n - 1), {})
            if (victim_peer.get("strikes", 0)
                    or victim_peer.get("decode_fails", 0)):
                raise AssertionError(
                    "spoof attempt charged the IMPERSONATED "
                    f"validator's budget record: {victim_peer}")
            out["guard"] = {
                "auth_failures": doc["auth_failures"],
                "auth_refused": auth_refused,
                "auth_ok": doc["auth_ok"],
                "impersonated_peer_doc": victim_peer,
                "injector": {
                    "mode": injector.mode,
                    "attempts": injector.attempts,
                    "refusals_observed": injector.refusals,
                    "hellos_accepted": injector.hellos_accepted,
                },
            }
        return out
    finally:
        stop_sampling.set()
        if sampler is not None:
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await sampler
        if watcher is not None:
            watcher.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await watcher
        if tower is not None:
            tower.close()
        if injector_task is not None:
            injector_task.cancel()
            with contextlib.suppress(asyncio.CancelledError, Exception):
                await injector_task
        await cluster.stop()


def run_socket_cell(spec: CellSpec, cell_dir: str, device="cuda"
                    ) -> Tuple[Dict[str, Any], AuditResult]:
    import asyncio

    live = asyncio.run(asyncio.wait_for(
        _socket_scenario(spec, cell_dir, device), 300))
    res, _journals = run_audit([cell_dir])
    detail = {
        "cell": spec.name,
        "spec": spec.as_dict(),
        "verdict": res.verdict,
        "batches_min": live["batches_min"],
        "batches_max": live["batches_max"],
        "stalled": live["batches_min"] == 0,
        "commit_wall_s": live["commit_wall_s"],
        "common_prefix_len": live["common_prefix_len"],
        "pipeline_depth": spec.pipeline_depth,
        "watch": live.get("watch"),
        "critical_path": _cell_critpath(cell_dir),
        "journal": cell_dir,
    }
    if "guard" in live:
        detail["guard"] = live["guard"]
        detail["overload_attributed_to"] = [
            o["peer"] for o in res.overload_incidents
        ]
    return detail, res


# ===========================================================================
# Grids
# ===========================================================================


def full_grid(seeds: Sequence[int] = (0, 1),
              churn_cells: int = 2) -> List[CellSpec]:
    """The default sweep: every (policy × adversary) pair on the 4-node
    topology per seed, a reduced n=7 slice, plus churn storms — ≥ 100
    cells at the default two seeds."""
    specs: List[CellSpec] = []
    for seed in seeds:
        for shape in PRESETS:
            for adv in ADVERSARIES:
                limit = 40_000
                if adv in ("equivocate", "vote-storm", "flood",
                           "future-spam", "spoof-replay"):
                    # never-draining queues (equivocator re-proposals) /
                    # multi-rotation storms / injected spam waves need
                    # the longer leash
                    limit = 60_000
                specs.append(CellSpec(
                    shape=shape, adversary=adv, n=4, seed=seed,
                    time_scale=SIM_SCALES.get(shape, 1e-3),
                    crank_limit=limit))
        # topology slice: the same stack at n=7 / f=2.  An equivocator's
        # own transactions never commit, so its queue re-proposes forever
        # and the run never drains — the crank bound IS the cell length;
        # 20k cranks is several committed epochs at n=7
        for shape in ("none", "wan-100ms", "lossy-1pct"):
            for adv in ("null", "reorder", "equivocate"):
                limit = 20_000 if adv == "equivocate" else 60_000
                specs.append(CellSpec(
                    shape=shape, adversary=adv, n=7, txs=7, seed=seed,
                    time_scale=SIM_SCALES.get(shape, 1e-3),
                    crank_limit=limit))
    for i in range(churn_cells):
        specs.append(CellSpec(kind="churn", shape="none",
                              adversary="null", n=4, seed=i))
    # WAN-shape cells against the PIPELINED socket cluster (ROADMAP item
    # 1 meets item 4): real transport, real chaos preset timings, epochs
    # kept in flight — the trajectory's second liveness point
    for shape in ("wan-100ms", "dup-reorder", "lossy-1pct"):
        specs.append(CellSpec(kind="socket", shape=shape,
                              adversary="null", n=4, seed=0,
                              pipeline_depth=2))
    # socket flood cells (overload defense, end to end): a raw-socket
    # injector claiming the last validator's identity streams garbage
    # (framing-valid, decode-invalid) or max-rate valid frames at a live
    # node — the cluster must keep committing, every buffer gauge stays
    # under its cap, and the audit attributes the incident to the
    # claimed peer from the journaled guard events
    for adv in SOCKET_FLOOD_ADVERSARIES:
        specs.append(CellSpec(kind="socket", shape="none",
                              adversary=adv, n=4, seed=0,
                              pipeline_depth=2))
    # bandwidth-asymmetry comparison cells (VID tentpole): one straggler
    # at 64 KB/s, classic RBC vs VID commitment ordering on the SAME
    # shape and seed, pipeline_depth=1 so the comparison is apples to
    # apples — classic serializes full payloads on the victim's uplink,
    # VID ships it an O(1/n) shard and must stay live AND audit clean
    # (cert-vs-retrieval corroboration included)
    for vid in (False, True):
        specs.append(CellSpec(kind="socket", shape="bandwidth-asym",
                              adversary="null", n=4, seed=0,
                              pipeline_depth=1, vid=vid))
    # socket identity-spoof cells (authenticated transport, end to
    # end): a raw-socket injector claims a correct validator's id
    # WITHOUT its key, in each refusal mode — every hello must die at
    # the challenge (zero frames into the protocol), the impersonated
    # validator's budget record stays clean, and the audit names the
    # attacker's endpoint
    for adv in SOCKET_SPOOF_ADVERSARIES:
        specs.append(CellSpec(kind="socket", shape="none",
                              adversary=adv, n=4, seed=0,
                              pipeline_depth=2))
    return specs


def smoke_grid() -> List[CellSpec]:
    """The tier-1 smoke: six fast simulator cells spanning every preset,
    all required to commit and audit clean — seconds, not minutes."""
    cells = [
        ("none", "null", 0),
        ("wan-100ms", "null", 0),
        ("lossy-1pct", "reorder", 1),
        ("dup-reorder", "null", 0),
        ("partition-10s", "null", 0),
        ("bandwidth-64k", "mitm-delay", 0),
    ]
    return [
        CellSpec(shape=shape, adversary=adv, seed=seed,
                 time_scale=SIM_SCALES.get(shape, 1e-3))
        for shape, adv, seed in cells
    ]


# ===========================================================================
# Campaign
# ===========================================================================


def _triage(spec: CellSpec, res: AuditResult) -> Dict[str, Any]:
    """Map a non-clean verdict to the facts an operator acts on: who,
    first divergent epoch, and the spec that replays it."""
    faulty: List[str] = []
    kinds: List[str] = []
    first: Optional[Tuple[int, int]] = None
    if res.equivocations:
        faulty = sorted({e["sender"] for e in res.equivocations})
        kinds = sorted({e["kind"] for e in res.equivocations})
        first = res.first_affected_epoch
    if res.first_divergence:
        d = res.first_divergence
        kinds = kinds + ["fork"]
        faulty = faulty or sorted(d.get("per_node", {}))
        first = first or (d["era"], d["epoch"])
    if res.monotonicity_violations and not faulty:
        faulty = sorted({v["node"] for v in res.monotonicity_violations})
        kinds = kinds + ["non-monotone"]
    return {
        "cell": spec.name,
        "verdict": res.verdict,
        "faulty_nodes": faulty,
        "first_divergent_epoch": list(first) if first else None,
        "kinds": kinds,
        "replay": {
            "seed": spec.seed,
            "spec": spec.as_dict(),
            "how": ("python -m hbbft_tpu_torch.chaos.campaign --replay "
                    "'<spec json>'"),
        },
    }


def run_campaign(specs: Sequence[CellSpec], journal_root: str,
                 verify_nonclean: bool = True,
                 progress=None, device="cuda") -> Dict[str, Any]:
    """Run every cell on ``device``, audit every journal set, build the
    report.  A cell that raises is reported as an ``error`` verdict; a
    device that cannot run raises here, before any cell."""
    resolve_device(device)
    os.makedirs(journal_root, exist_ok=True)
    details: List[Dict[str, Any]] = []
    triage: List[Dict[str, Any]] = []
    verdicts: Dict[str, int] = {}
    frames = {"shaped": 0, "dropped": 0, "delayed": 0, "duplicated": 0,
              "partition_holds": 0}
    errors = 0
    epoch_lat: List[float] = []
    for idx, spec in enumerate(specs):
        cell_dir = os.path.join(journal_root, f"{idx:04d}--{spec.name}")
        try:
            if spec.kind == "churn":
                detail, res = run_churn_cell(spec, cell_dir, device)
            elif spec.kind == "socket":
                detail, res = run_socket_cell(spec, cell_dir, device)
            else:
                detail, res = run_cell(spec, cell_dir, device)
        except Exception as exc:
            errors += 1
            detail = {"cell": spec.name, "spec": spec.as_dict(),
                      "verdict": "error", "error": repr(exc)}
            res = None
        verdict = detail["verdict"]
        verdicts[verdict] = verdicts.get(verdict, 0) + 1
        shaping = detail.get("shaping")
        if shaping:
            for k in frames:
                frames[k] += shaping.get(k, 0)
        if detail.get("epoch_virtual_s") is not None:
            epoch_lat.append(detail["epoch_virtual_s"])
        if res is not None and res.verdict != "clean":
            entry = _triage(spec, res)
            if (verify_nonclean and spec.kind == "sim"
                    and not spec.faulty):
                # a non-clean verdict with NO configured Byzantine node
                # is either a real bug or nondeterminism — prove which:
                # the replay must reproduce byte-identically
                entry["reproduced"] = replay_matches(
                    spec, detail["timeline_digest"],
                    os.path.join(cell_dir, "replay-check"), device)
            triage.append(entry)
        details.append(detail)
        if progress is not None:
            progress(idx + 1, len(specs), detail)
    cells = len(details)
    clean = verdicts.get("clean", 0)
    epoch_lat.sort()
    report = {
        "metric": "chaos_campaign",
        "value": round(clean / cells, 4) if cells else 0.0,
        "unit": "clean_fraction",
        "cells": cells,
        "policies": sorted({s.shape for s in specs}),
        "adversaries": sorted({s.adversary for s in specs}),
        "topologies": sorted({s.n for s in specs}),
        "seeds": sorted({s.seed for s in specs}),
        "verdicts": verdicts,
        "errors": errors,
        "stalled_cells": sum(1 for d in details if d.get("stalled")),
        "frames": frames,
        "epoch_virtual_s_p50": (
            round(epoch_lat[len(epoch_lat) // 2], 6) if epoch_lat
            else None),
        "triage": triage,
        "cells_detail": details,
    }
    return report


#: incident kinds that constitute an ALARM (fault/fork classes) — the
#: info-class kinds (overload attribution, restart re-proposals) are
#: working-as-designed annotations, not alarms, and never count as a
#: false positive on a clean cell
ALARM_KINDS = frozenset({
    "fork", "self_fork", "sync_mismatch", "vid_mismatch",
    "status_mismatch", "equivocation", "monotonicity",
})


def build_obs_report(report: Dict[str, Any]) -> Dict[str, Any]:
    """Distill the campaign's per-cell watch blocks into the
    online-detection record: for every cell with a configured Byzantine
    node, was the fault flagged ONLINE (incident naming the faulty node
    before the cell ended) and at what detection latency; for every
    clean cell, did the live plane stay silent.  Sim cells measure
    latency on the virtual clock, socket cells on the wall clock —
    ``clock`` says which."""
    detection: List[Dict[str, Any]] = []
    false_alarms: List[Dict[str, Any]] = []
    fault_cells = flagged = 0
    lat: List[float] = []
    for d in report["cells_detail"]:
        w = d.get("watch")
        if not w:
            continue
        spec = CellSpec.from_dict(d.get("spec", {}))
        if spec.faulty:
            fault_cells += 1
            detect_s, clock = w.get("detect_virtual_s"), "virtual"
            if detect_s is None and w.get("detect_wall_s") is not None:
                detect_s, clock = w.get("detect_wall_s"), "wall"
            if w.get("detected_online"):
                flagged += 1
                if detect_s is not None:
                    lat.append(detect_s)
            detection.append({
                "cell": d["cell"],
                "adversary": spec.adversary,
                "detected_online": bool(w.get("detected_online")),
                "kind": w.get("first_kind"),
                "detect_s": detect_s,
                "clock": clock,
                "detect_cranks": w.get("detect_cranks"),
            })
        else:
            alarms = sorted(
                tuple(i) for i in w.get("incidents", ())
                if tuple(i)[0] in ALARM_KINDS)
            if alarms and d.get("verdict") == "clean":
                false_alarms.append(
                    {"cell": d["cell"], "incidents": alarms})
    lat.sort()
    return {
        "metric": "chaos_online_detection",
        "value": (round(flagged / fault_cells, 4)
                  if fault_cells else None),
        "unit": "flagged_fraction",
        "fault_cells": fault_cells,
        "flagged_online": flagged,
        "clean_false_alarms": len(false_alarms),
        "false_alarm_cells": false_alarms,
        "detect_p50_s": (round(lat[len(lat) // 2], 6) if lat else None),
        "detect_max_s": (round(lat[-1], 6) if lat else None),
        "detection": detection,
        "clean_fraction": report.get("value"),
    }


# ===========================================================================
# CLI
# ===========================================================================


def _load_spec(arg: str) -> CellSpec:
    if arg.startswith("@"):
        with open(arg[1:], encoding="utf-8") as fh:
            doc = json.load(fh)
    else:
        doc = json.loads(arg)
    # a triage entry's replay block is accepted directly
    if "spec" in doc and isinstance(doc["spec"], dict):
        doc = doc["spec"]
    return CellSpec.from_dict(doc)


def run_replay(spec: CellSpec, journal_root: str,
               keep_journals: bool = False, device="cuda") -> int:
    """Replay one cell twice on ``device`` and verify byte-identity (the
    triage workflow: paste the reported spec, watch the same failure
    again)."""
    from hbbft_tpu_torch.obs.audit import format_report

    d1, res1 = run_cell(spec, os.path.join(journal_root, "replay-a"), device)
    d2, _res2 = run_cell(spec, os.path.join(journal_root, "replay-b"), device)
    identical = d1["timeline_digest"] == d2["timeline_digest"]
    sys.stdout.write(format_report(res1))
    doc = {
        "metric": "chaos_replay",
        "cell": spec.name,
        "verdict": d1["verdict"],
        "timeline_digest": d1["timeline_digest"],
        "byte_identical": identical,
    }
    if keep_journals:
        # only advertise the journal path when it survives this process
        # (no --journal-root → the temp root is deleted on exit)
        doc["journal"] = d1["journal"]
    print(json.dumps(doc))
    return 0 if identical else 3


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m hbbft_tpu_torch.chaos.campaign", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--grid", choices=("full", "smoke"), default="full")
    ap.add_argument("--seeds", type=int, default=2,
                    help="scenario seeds per (policy × adversary) cell "
                         "in the full grid")
    ap.add_argument("--churn", type=int, default=2,
                    help="kill/restart storm cells over a real socket "
                         "cluster (full grid only)")
    ap.add_argument("--max-cells", type=int, default=0,
                    help="cap the grid (0 = run everything)")
    ap.add_argument("--out", default="",
                    help="write the JSON report here (default: stdout)")
    ap.add_argument("--obs-out", default="",
                    help="also write the online-detection record "
                         "(per-cell detection latency) here")
    ap.add_argument("--journal-root", default="",
                    help="keep cell journals under this directory "
                         "(default: a temp dir, deleted after the run)")
    ap.add_argument("--no-verify", action="store_true",
                    help="skip the byte-identity replay of non-clean "
                         "correct-node cells")
    ap.add_argument("--replay", metavar="SPEC",
                    help="replay ONE cell from a JSON CellSpec (inline "
                         "or @file; a triage entry's replay block works "
                         "verbatim) and verify byte-identity")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every cell's device work "
                         "(default cuda; raises without a card — pass "
                         "cpu to run the plain PyTorch versions)")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    import shutil
    import tempfile

    root = args.journal_root or tempfile.mkdtemp(prefix="hbbft-chaos-")
    keep = bool(args.journal_root)
    try:
        if args.replay:
            return run_replay(_load_spec(args.replay), root,
                              keep_journals=keep, device=args.device)
        if args.grid == "smoke":
            specs = smoke_grid()
        else:
            specs = full_grid(seeds=list(range(args.seeds)),
                              churn_cells=args.churn)
        if args.max_cells:
            specs = specs[: args.max_cells]

        def progress(i, total, detail):
            print(f"# [{i}/{total}] {detail['cell']}: "
                  f"{detail['verdict']}"
                  + (f" batches={detail.get('batches_min')}"
                     if "batches_min" in detail else ""),
                  file=sys.stderr, flush=True)

        report = run_campaign(specs, root,
                              verify_nonclean=not args.no_verify,
                              progress=progress, device=args.device)
        if args.obs_out:
            obs_doc = build_obs_report(report)
            with open(args.obs_out, "w", encoding="utf-8") as fh:
                fh.write(json.dumps(obs_doc) + "\n")
            print(f"# online-detection record written to "
                  f"{args.obs_out} (flagged "
                  f"{obs_doc['flagged_online']}/"
                  f"{obs_doc['fault_cells']}, false alarms "
                  f"{obs_doc['clean_false_alarms']})",
                  file=sys.stderr)
        if not keep:
            # journals were a working set; the report is the artifact
            for d in report["cells_detail"]:
                d.pop("journal", None)
        doc = json.dumps(report)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")
            print(f"# report written to {args.out}", file=sys.stderr)
        else:
            print(doc)
        return 0
    finally:
        if not keep:
            shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
