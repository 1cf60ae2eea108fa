"""Driver entry points of the port: one RBC round, and the multi-rank dry run.

Counterpart of the repository root's ``__graft_entry__.py``:

- ``entry(device="cuda")`` returns ``(fn, args)``: one full batched RBC
  round at N = 16 (N proposers RS-encode + Merkle-commit, N receivers
  verify, count and decode) and its framed input on ``device``;
- ``dryrun_multichip(n_devices, quick=False, device="cuda")`` spawns one
  process per device (an NCCL world, one rank a card; or a gloo world on
  the CPU with ``device="cpu"``), runs on a ``DeviceMesh`` what the
  reference's dry run runs — the sharded RBC on a 1-D and a 2-D mesh, the
  sharded ABA, one full sharded HoneyBadger epoch held equal to the
  one-device epoch, and unless ``quick`` the large-N sharded RBC — checks
  that ``parallel.mesh.STATS`` moved, and prints the reference's
  ``multichip_epoch_trajectory`` JSON record on one line.  It raises when
  fewer cards are visible than it was asked for.

The ranks meet through a ``FileStore`` in a temporary directory (no
network), and the kernels and the native oracle are built here, before
the ranks start.  :func:`start_world` is the same machinery for any
module-level function; the rank workers of the CPU parity tests are at the
end of this module, so that a rank never imports the JAX package.

    python -m hbbft_tpu_torch.graft_entry [n_devices] [--quick] [--cpu]
"""

from __future__ import annotations

import json
import os
import queue as queue_mod
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from hbbft_tpu_torch import resolve_device


def entry(device="cuda"):
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc, frame_values

    n, f = 16, 5
    rbc = BatchedRbc(n, f)
    values = [bytes([p]) * 24 for p in range(n)]
    data = torch.from_numpy(frame_values(values, rbc.k)).to(resolve_device(device))

    def fn(d):
        out = rbc.run(d)
        return out["delivered"], out["fault"], out["data"], out["root"]

    return fn, (data,)


# ---------------------------------------------------------------- the world


def _rank_main(rank, world_size, device_type, store_path, target, args_path, results):
    """One rank: join the world, run ``target(*args)`` (``args`` pickled at
    ``args_path``), report to the parent."""
    import pickle

    import torch.distributed as dist

    try:
        with open(args_path, "rb") as fh:
            args = pickle.load(fh)
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
            backend = "nccl"
        else:
            torch.set_num_threads(1)
            backend = "gloo"
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:  # the parent raises it, with the rank's traceback
        results.put((rank, False, traceback.format_exc()))


class World:
    """``n_ranks`` spawned processes, each running ``target(*args)`` in a
    ``torch.distributed`` world (see :func:`start_world`)."""

    def __init__(self, n_ranks, target, args, device_type):
        import multiprocessing

        import pickle

        ctx = multiprocessing.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory()
        self._queue = ctx.Queue()
        store = os.path.join(self._tmp.name, "store")
        # the arguments go through a file: a large pickle sent down each
        # rank's start pipe would hold the parent until that rank imported
        args_path = os.path.join(self._tmp.name, "args.pickle")
        with open(args_path, "wb") as fh:
            pickle.dump(args, fh)
        self._procs = [
            ctx.Process(target=_rank_main,
                        args=(r, n_ranks, device_type, store, target, args_path,
                              self._queue),
                        daemon=True)
            for r in range(n_ranks)
        ]
        for p in self._procs:
            p.start()
        self._results = None

    def results(self, timeout_s: float = 600.0) -> list:
        """Every rank's return value, in rank order; raises with a rank's
        traceback when one failed, or when the ranks outlast ``timeout_s``."""
        if self._results is not None:
            return self._results
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < len(self._procs):
                try:
                    rank, ok, payload = self._queue.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue_mod.Empty:
                    raise TimeoutError(f"ranks {sorted(set(range(len(self._procs))) - set(got))} "
                                       f"did not finish within {timeout_s} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{payload}")
                got[rank] = payload
        finally:
            self.close()
        self._results = [got[r] for r in range(len(self._procs))]
        return self._results

    def close(self) -> None:
        """Stop every rank still running and remove the store."""
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        self._tmp.cleanup()


def start_world(n_ranks: int, target, args=(), device="cuda") -> World:
    """Start ``n_ranks`` ranks running ``target(*args)`` (a module-level
    function, sent by import path) in one world: NCCL with a card each for
    ``device="cuda"``, gloo on the CPU for ``device="cpu"``.  Raises when
    fewer cards are visible than ranks.  On the card the kernels and the
    native oracle are built first, here, so that the ranks do not race to
    build them.  Read the results with :meth:`World.results`."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_ranks:
            raise RuntimeError(
                f"{n_ranks} ranks need {n_ranks} CUDA cards; "
                f"{torch.cuda.device_count()} visible"
            )
        from hbbft_tpu_torch import _build
        from hbbft_tpu_torch.native import get_oracle

        _build.build_all()
        get_oracle()
    return World(n_ranks, target, tuple(args), dev.type)


def _meshes(device_type: str):
    """The world as a 1-D ``("nodes",)`` mesh and a 2-D ``("dcn", "ici")``
    one (2 × ws/2 for an even world size, else 1 × ws)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    ws = dist.get_world_size()
    rows = 2 if ws % 2 == 0 else 1
    return (init_device_mesh(device_type, (ws,), mesh_dim_names=("nodes",)),
            init_device_mesh(device_type, (rows, ws // rows), mesh_dim_names=("dcn", "ici")))


# ----------------------------------------------------------------- dry run


def _stats_delta(before):
    from hbbft_tpu_torch.parallel import mesh as mesh_mod

    after = mesh_mod.stats_snapshot()
    return {ph: {k: after[ph][k] - before[ph][k] for k in after[ph]} for ph in sorted(after)}


def _dryrun_rank(n_devices: int, quick: bool, device_type: str) -> dict:
    """The dry run on one rank; every rank runs it and returns its record."""
    import random as pyrandom

    import torch.distributed as dist

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel import mesh as mesh_mod
    from hbbft_tpu_torch.parallel.aba import BatchedAba
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc, frame_values, unframe_value

    mesh, mesh2d = _meshes(device_type)
    dev = mesh_mod.mesh_device(mesh)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    stats_before = mesh_mod.stats_snapshot()
    # the reference's dry run runs N = n_devices; N ≥ 4 keeps f ≥ 1 here
    n = n_devices * -(-4 // n_devices)
    f = (n - 1) // 3
    rbc = BatchedRbc(n, f)
    values = [bytes([p + 1]) * (p + 1) for p in range(n)]
    data = torch.from_numpy(frame_values(values, rbc.k)).to(dev)

    out = mesh_mod.sharded_rbc_run(rbc, mesh, data)
    delivered = out["delivered"]
    if not bool(delivered.all()) or bool(out["fault"].any()):
        raise AssertionError("sharded RBC: not every proposer delivered")
    for j in range(n):
        for p in range(n):
            if unframe_value(out["data"][j, p]) != values[p]:
                raise AssertionError(f"sharded RBC: receiver {j}, proposer {p}")
    # the one-device masked path (all-ones masks: the maskless call takes
    # the shared-row fast path, whose layout differs by design)
    ones_vm = torch.ones((n, n), dtype=torch.bool, device=dev)
    ones_em = torch.ones((n, n, n), dtype=torch.bool, device=dev)
    single = rbc.run(data, value_mask=ones_vm, echo_mask=ones_em, ready_mask=ones_em)
    out2d = mesh_mod.sharded_rbc_run(rbc, mesh2d, data)
    for key in single:
        if not (torch.equal(out[key], single[key]) and torch.equal(out2d[key], single[key])):
            raise AssertionError(f"sharded RBC: {key} differs from the one-device round")

    aba = BatchedAba(n, f)
    st = aba.init_state(delivered)
    step = mesh_mod.make_sharded_aba_step(aba, mesh)
    for _ in range(9):
        st = step(st, torch.zeros((n,), dtype=torch.bool, device=dev))
        if bool(st["decided"].all()):
            break
    if not (bool(st["decided"].all()) and bool(st["decision"].all())):
        raise AssertionError("sharded ABA: not every instance decided true")

    netinfo = NetworkInfo.generate_map(list(range(n)), pyrandom.Random(7))
    contribs = {i: bytes([i + 1]) * (4 + i) for i in range(n)}

    def timed_epoch(hb):
        # the second run is timed, the first pays first-use costs
        hb.run(dict(contribs), pyrandom.Random(42))
        sync()
        t0 = time.perf_counter()
        batch, detail = hb.run(dict(contribs), pyrandom.Random(42))
        sync()
        return time.perf_counter() - t0, batch, detail

    t_s, batch_s, out_s = timed_epoch(
        BatchedHoneyBadgerEpoch(netinfo, session_id=b"dryrun", device=dev))
    t_m, batch_m, out_m = timed_epoch(
        BatchedHoneyBadgerEpoch(netinfo, session_id=b"dryrun", mesh=mesh))
    if not (batch_m == batch_s == contribs
            and np.array_equal(out_m["accepted"], out_s["accepted"])):
        raise AssertionError("the sharded epoch differs from the one-device epoch")
    trajectory = [{"n_devices": 1, "epochs_per_s": round(1.0 / t_s, 4)},
                  {"n_devices": n_devices, "epochs_per_s": round(1.0 / t_m, 4)}]

    if not quick:
        # the large-N (> 256, GF(2^16)) scale path: the smallest N past the
        # GF(2^8) boundary that the mesh divides, tiny payloads
        nl = (256 // n_devices + 1) * n_devices
        rbc_l = BatchedRbc(nl, (nl - 1) // 3)
        values_l = [bytes([p % 251 + 1]) * 2 for p in range(nl)]
        data_l = torch.from_numpy(frame_values(values_l, rbc_l.k)).to(dev)
        out_l = mesh_mod.make_sharded_rbc_large_run(rbc_l, mesh)(data_l)
        single_l = rbc_l.run(data_l)
        if not (np.array_equal(out_l["delivered"], single_l["delivered"])
                and np.array_equal(out_l["data"], single_l["data"])
                and out_l["delivered"].all()
                and unframe_value(out_l["data"][0, 0]) == values_l[0]):
            raise AssertionError("the sharded large-N round differs from the one-device round")

    mesh_stats = _stats_delta(stats_before)
    engaged = all(mesh_stats[ph]["collectives"] > 0 for ph in ("rbc", "aba", "decrypt"))
    if not engaged:
        raise AssertionError(f"the sharded epoch ran but the mesh counters idled: {mesh_stats}")
    return {
        "metric": "multichip_epoch_trajectory",
        "value": trajectory[-1]["epochs_per_s"],
        "unit": "epochs/s",
        "n_devices": n_devices,
        "n": n,
        "rank": dist.get_rank(),
        "sharded_epoch_engaged": engaged,
        "trajectory": trajectory,
        "mesh_stats": mesh_stats,
        "quick": bool(quick),
        "device": str(dev),
        "ok": True,
    }


def dryrun_multichip(n_devices: int, quick: bool = False, device="cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks (see the module docstring);
    prints rank 0's record as one JSON line and returns it."""
    dev = resolve_device(device)
    world = start_world(n_devices, _dryrun_rank, (n_devices, quick, dev.type), dev)
    records = world.results(timeout_s=1800)
    if len({json.dumps(r["mesh_stats"], sort_keys=True) for r in records}) != 1:
        raise AssertionError("the ranks' mesh counters disagree")
    print(json.dumps(records[0]), flush=True)
    return records[0]


# ------------------------------------------- rank workers of the CPU tests


def _check_rbc(meshes, spec):
    from hbbft_tpu_torch.parallel import mesh as mesh_mod
    from hbbft_tpu_torch.parallel.acs import _host
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc

    rbc = BatchedRbc(spec["n"], spec["f"])
    mesh = meshes[spec["mesh"]]
    data = torch.from_numpy(spec["data"])
    if rbc.large:
        run = mesh_mod.make_sharded_rbc_large_run(rbc, mesh)
    else:
        run = mesh_mod.make_sharded_rbc_run(rbc, mesh)
    saved = mesh_mod.RECEIVER_CHUNK_BYTES
    mesh_mod.RECEIVER_CHUNK_BYTES = spec.get("receiver_chunk_bytes", saved)
    try:
        return {k: _host(v) for k, v in run(data, **spec["kwargs"]).items()}
    finally:
        mesh_mod.RECEIVER_CHUNK_BYTES = saved


def _check_aba(meshes, spec):
    from hbbft_tpu_torch.parallel import mesh as mesh_mod
    from hbbft_tpu_torch.parallel.acs import _host
    from hbbft_tpu_torch.parallel.aba import BatchedAba

    aba = BatchedAba(spec["n"], spec["f"])
    step = mesh_mod.make_sharded_aba_step(aba, meshes["1d"])
    st = aba.init_state(torch.from_numpy(spec["est"]))
    states = []
    for coins, masks in zip(spec["coins"], spec["masks"]):
        st = step(st, torch.from_numpy(coins), **{k: torch.from_numpy(m) for k, m in masks.items()})
        states.append({k: _host(st[k]) for k in ("est", "decided", "decision")})
    return states


def _check_epoch(meshes, spec):
    import random as pyrandom

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    ids = list(range(spec["n"]))
    nets = NetworkInfo.generate_map(ids, pyrandom.Random(spec["seed"]))
    hb = BatchedHoneyBadgerEpoch(nets, session_id=spec["session"], device="cpu",
                                 encrypt_backend="device", mesh=meshes["1d"])
    payloads = hb.encrypt_phase(spec["contribs"], pyrandom.Random(42))
    batch, out = hb.run_from_payloads(payloads)
    return {"payloads": payloads, "batch": batch, "epochs": out["epochs"],
            "accepted": out["accepted"], "delivered": out["delivered"]}


def _check_dhb_fallback(meshes, spec):
    import random as pyrandom

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.dhb import BatchedDynamicHoneyBadger

    nets = NetworkInfo.generate_map(list(range(spec["n"])), pyrandom.Random(77))
    dhb = BatchedDynamicHoneyBadger(nets, session_id=b"mesh-dhb", rng=pyrandom.Random(5),
                                    device="cpu", mesh=meshes["1d"])
    batch = dhb.run_epoch({nid: b"m1-%d" % nid for nid in dhb.validators})
    return {"epoch_mesh": dhb.hb.mesh is not None, "acs_mesh": dhb.hb.acs.mesh is not None,
            "contributions": dict(batch.contributions)}


def _check_coin(meshes, spec):
    import random as pyrandom

    from hbbft_tpu_torch.crypto.tc import SecretKeySet
    from hbbft_tpu_torch.parallel.mesh import make_sharded_coin_verify

    rng = pyrandom.Random(spec["seed"])
    sks = SecretKeySet.random(spec["f"], rng)
    pks = sks.public_keys()
    msg = spec["msg"]
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(msg))
             for i in range(spec["n"])]
    forged = list(pairs)
    forged[-1] = (pairs[-1][0], sks.secret_key_share(spec["n"] - 1).sign(b"not it"))
    verify = make_sharded_coin_verify(meshes["1d"], "cpu")
    return {"honest": verify(pairs, msg, rng), "forged": verify(forged, msg, rng)}


class _SpyGathers:
    """Record each row gather of a mesh's ladder cache (its group) inside
    the ``with`` block."""

    def __init__(self, cache):
        self.cache = cache
        self.calls = []

    def __enter__(self):
        gather_rows = self.cache._gather_rows

        def spy(group, *args):
            self.calls.append(group)
            return gather_rows(group, *args)

        self.cache._gather_rows = spy
        return self.calls

    def __exit__(self, *exc):
        del self.cache._gather_rows
        return False


def _check_decrypt(meshes, spec):
    """The decrypt hook; with ``spec["device_route"]`` on the row-sharded
    ladder (no native oracle, the device threshold at 1)."""
    import random as pyrandom

    from hbbft_tpu_torch.crypto import batch as tb
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.crypto.tc import SecretKeySet
    from hbbft_tpu_torch.parallel.mesh import make_sharded_decrypt

    sks = SecretKeySet.random(spec["f"], pyrandom.Random(spec["seed"]))
    pks = sks.public_keys()
    shares = [(i, sks.secret_key_share(i)) for i in range(spec["f"] + 1)]
    decrypt = make_sharded_decrypt(meshes["1d"], "cpu")
    saved = tb.DEVICE_DECRYPT_MIN_BATCH, c._native
    if spec["device_route"]:
        tb.DEVICE_DECRYPT_MIN_BATCH, c._native = 1, lambda: None
    try:
        with _SpyGathers(tb.cache_for("cpu", meshes["1d"])) as gathers:
            plain = decrypt(pks, spec["payloads"], shares)
        try:
            decrypt(pks, spec["bad"], shares)
            rejected = False
        except ValueError:
            rejected = True
    finally:
        tb.DEVICE_DECRYPT_MIN_BATCH, c._native = saved
    return {"plaintexts": plain, "bad_rejected": rejected, "gathers": gathers}


def _check_msm(meshes, spec):
    from hbbft_tpu_torch.crypto import batch as tb
    from hbbft_tpu_torch.crypto import bls12_381 as c

    cache = tb.cache_for("cpu", meshes["1d"])
    out = {}
    for rows in spec["rows"]:
        pts = [c.g1_mul(c.G1_GEN, 3 + 5 * i) for i in range(rows - 1)] + [None]
        sc = [(0x9E3779B97F4A7C15 * (i + 1)) % (1 << 128) | 1 for i in range(rows)]
        with _SpyGathers(cache) as gathers:
            got = cache.msm_g1(pts, sc)
        out[rows] = {"sharded": bool(gathers), "msm": c.g1_to_bytes(got),
                     "host": c.g1_to_bytes(_host_msm(c, pts, sc))}
    return out


def _host_msm(c, pts, sc):
    acc = None
    for p, s in zip(pts, sc):
        if p is not None:
            acc = c.g1_add(acc, c.g1_mul(p, s))
    return acc


_CHECKS = {"rbc": _check_rbc, "aba": _check_aba, "epoch": _check_epoch,
           "dhb_fallback": _check_dhb_fallback, "coin": _check_coin,
           "decrypt": _check_decrypt, "msm": _check_msm}


def check_rank(cases) -> dict:
    """Rank worker of the CPU parity tests: run each ``(name, kind, spec)``
    case on the gloo world's 1-D and 2-D meshes; returns ``{name: {"out":
    ..., "stats": the STATS delta}}``."""
    from hbbft_tpu_torch.parallel import mesh as mesh_mod

    meshes = dict(zip(("1d", "2d"), _meshes("cpu")))
    res = {}
    for name, kind, spec in cases:
        before = mesh_mod.stats_snapshot()
        out = _CHECKS[kind](meshes, spec)
        res[name] = {"out": out, "stats": _stats_delta(before)}
    return res


if __name__ == "__main__":
    argv = sys.argv[1:]
    n_dev = int(next((a for a in argv if not a.startswith("--")), "1"))
    dryrun_multichip(n_dev, quick="--quick" in argv, device="cpu" if "--cpu" in argv else "cuda")
