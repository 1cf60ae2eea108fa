"""Protocol rounds sharded over a device mesh, one process per device.

Counterpart of ``hbbft_tpu/parallel/mesh.py``.  The reference runs one
controller over a ``jax.sharding.Mesh`` with ``shard_map``; here every rank
of a ``torch.distributed`` world runs the same driver code on the same
seeded inputs (SPMD), and the mesh is PyTorch's own
``torch.distributed.device_mesh.DeviceMesh``, with one axis (``("nodes",)``)
or two (``("dcn", "ici")``: hosts over the data-center network × cards of a
host).  The node axis is the data-parallel axis: each rank owns a
contiguous slice of nodes (row-major over the mesh axes), runs their
proposer phase and their receiver phase, and the *network* between the
phases is an ``all_gather`` over the mesh axes, innermost axis first, so a
cross-host hop carries each block once.  Vote counts are an ``all_reduce``
in int32.  Every result comes back replicated on every rank and equal, bit
for bit, to the single-device path.

Collectives run on the stream of the work they follow: NCCL on the card
(bool tensors cross as their uint8 view), gloo on the CPU.  Every rank must
issue the same collectives in the same order, so nothing here draws
randomness or branches on a rank's own data.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from hbbft_tpu_torch import resolve_device
from hbbft_tpu_torch.parallel.aba import (
    SBV_INF_FULL,
    SBV_ROUNDS_FULL,
    _coin,
    _count,
    aux_pref_from_crossings,
    sbv_inf_masked,
    sbv_round_model,
    sbv_rounds_masked,
)

# Host-side accounting of the sharded wrappers' collective traffic, with
# the reference's phase names, fields and byte formulas: ``collectives``
# counts mesh-spanning collective groups (one per mesh axis);
# ``gather_bytes`` the bytes they return, from the array shapes (shard +
# root payloads for RBC, Merkle proofs excluded; gathered state rows for
# ABA; affine point bytes for the crypto phases).
STATS = {
    ph: {"collectives": 0, "gather_bytes": 0}
    for ph in ("rbc", "aba", "coin", "decrypt")
}


def stats_snapshot():
    """Copy of the per-phase mesh-collective counters."""
    return {ph: dict(v) for ph, v in STATS.items()}


def _account(phase: str, collectives: int, gather_bytes: int) -> None:
    s = STATS[phase]
    s["collectives"] += int(collectives)
    s["gather_bytes"] += int(gather_bytes)


def mesh_device(mesh) -> torch.device:
    """The device a mesh fixes for this rank: ``cuda:<local rank>`` for a
    CUDA mesh (raising without a card), the CPU for a gloo one."""
    if mesh.device_type == "cuda":
        resolve_device("cuda")
        return torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    if mesh.device_type != "cpu":
        raise ValueError(f"mesh device type {mesh.device_type!r}: expected 'cuda' or 'cpu'")
    return torch.device("cpu")


def runner_device(mesh, device) -> torch.device:
    """The device of a runner: the mesh's for this rank where there is a
    mesh, else ``device`` (raising for CUDA without a card)."""
    return resolve_device(device) if mesh is None else mesh_device(mesh)


def _all_gather0(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` of ``group`` along dim 0, rank order."""
    is_bool = x.dtype == torch.bool
    x = x.contiguous()
    if is_bool:
        x = x.view(torch.uint8)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.cat(parts)
    return out.view(torch.bool) if is_bool else out


def gather_nodes(x: torch.Tensor, mesh) -> torch.Tensor:
    """all_gather the leading (node-sharded) axis back to full size —
    innermost mesh axis first, then outward."""
    for d in reversed(range(mesh.ndim)):
        x = _all_gather0(x, mesh.get_group(d))
    return x


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over every rank of the mesh, in int32."""
    y = x.to(torch.int32).contiguous().clone()
    for d in reversed(range(mesh.ndim)):
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group(d))
    return y


def flat_rank(mesh) -> int:
    """This rank's index in the node-axis sharding (row-major over the mesh
    axes)."""
    coord = mesh.get_coordinate()
    idx = coord[0]
    for d in range(1, mesh.ndim):
        idx = idx * mesh.size(d) + coord[d]
    return idx


def _node_slice(n: int, mesh) -> slice:
    n_dev = mesh.size()
    if n % n_dev:
        raise ValueError(f"the mesh's {n_dev} ranks do not divide N = {n}")
    per = n // n_dev
    lo = flat_rank(mesh) * per
    return slice(lo, lo + per)


# Receivers a ``run_from_proposal`` call decodes for, at most: each holds a
# (P, n, B) copy of the shards, re-encoded through float32 bit planes
# (~40 bytes of working set per shard byte), so a rank decodes its slice in
# chunks of this many shard bytes; the results do not depend on it.
RECEIVER_CHUNK_BYTES = 1 << 28


def make_sharded_rbc_run(rbc, mesh):
    """A sharded RBC round for ``(rbc, mesh)``: this rank's proposers
    ``propose``, shards, roots and proofs are gathered, then
    ``run_from_proposal`` decodes for this rank's receivers, and the
    per-receiver arrays are gathered back to full size.  A rank decodes its
    receivers in chunks of ``RECEIVER_CHUNK_BYTES`` shard bytes.

    Returns ``run(data, codeword_tamper=None, value_tamper=None,
    value_mask=None, echo_mask=None, ready_mask=None)`` with the result of
    ``BatchedRbc.run`` on the masked path (tensors on ``data``'s device,
    ``data`` holding a row per receiver)."""
    n = rbc.n
    mine = _node_slice(n, mesh)
    n_axes = mesh.ndim

    def run(data, codeword_tamper=None, value_tamper=None, value_mask=None,
            echo_mask=None, ready_mask=None):
        P, k, B = data.shape
        dev = data.device
        # three gathers (shards, roots, proofs) per mesh axis; bytes are
        # the shard + root payloads every rank receives
        _account("rbc", 3 * n_axes, P * n * B + P * 32)

        def on(x, dtype, shape, fill):
            if x is None:
                return torch.full(shape, fill, dtype=dtype, device=dev)
            return torch.as_tensor(x, dtype=dtype, device=dev)

        cw = on(codeword_tamper, torch.uint8, (P, n, B), 0)
        vt = on(value_tamper, torch.uint8, (P, n, B), 0)
        vm = on(value_mask, torch.bool, (P, n), True)
        em = on(echo_mask, torch.bool, (n, n, P), True)
        rm = on(ready_mask, torch.bool, (n, n, P), True)
        props = _node_slice(P, mesh)
        shards, root, proofs, pmask = rbc.propose(data[props], cw[props])
        shards = gather_nodes(shards ^ vt[props], mesh)  # (P, n, B)
        root = gather_nodes(root, mesh)  # (P, 32)
        proofs = gather_nodes(proofs, mesh)  # (P, n, D, 32)
        chunk = max(1, RECEIVER_CHUNK_BYTES // (P * n * B))
        outs = [
            rbc.run_from_proposal(
                shards, root, proofs, pmask, vm, em, rm,
                receivers=torch.arange(lo, min(lo + chunk, mine.stop), device=dev),
            )
            for lo in range(mine.start, mine.stop, chunk)
        ]
        return {
            key: root if key == "root" else gather_nodes(torch.cat([o[key] for o in outs]), mesh)
            for key in outs[0]
        }

    return run


def sharded_rbc_run(rbc, mesh, data, **kwargs):
    """One-shot :func:`make_sharded_rbc_run`."""
    return make_sharded_rbc_run(rbc, mesh)(data, **kwargs)


def make_sharded_rbc_large_run(rbc, mesh):
    """The large-N (N > 256, GF(2^16)) full-delivery RBC round with the
    PROPOSER axis sharded over ``mesh``: every stage is proposer-parallel,
    so each rank runs ``large_stage_a``/``large_stage_b`` on its slice of
    proposers and the per-proposer outputs are gathered back to full size;
    the host decisions between the stages (``BatchedRbc.finish_large``)
    run on every rank.  Returns ``run(data, codeword_tamper=None,
    value_tamper=None)`` with the ``BatchedRbc.run`` result contract."""
    n_axes = mesh.ndim

    def run(data, codeword_tamper=None, value_tamper=None):
        P = data.shape[0]
        # two stage launches re-assemble their per-proposer outputs across
        # the mesh once each (counted per axis); the bytes are the framed
        # data that leaves each rank
        _account("rbc", 2 * n_axes, int(np.prod(tuple(data.shape))))
        mine = _node_slice(P, mesh)
        cs = rbc._large_chunk_size(mine.stop - mine.start)

        def local(t):
            return None if t is None else torch.as_tensor(t, device=data.device)[mine]

        a_out = rbc.large_stage_a(
            data[mine], local(codeword_tamper), local(value_tamper), cs
        )

        def stage_b(dr, sent_, vv_, root_):
            b_out = rbc.large_stage_b(dr[mine], sent_[mine], vv_[mine], root_[mine], cs)
            return tuple(gather_nodes(t, mesh) for t in b_out)

        return rbc.finish_large(tuple(gather_nodes(t, mesh) for t in a_out), stage_b)

    return run


def make_sharded_aba_step(aba, mesh):
    """An ABA epoch step with the node-state rows sharded over ``mesh``:
    the semantics of ``BatchedAba.epoch_step``, bit for bit.  Each rank
    computes its rows; the BVal/Aux/Conf exchanges become ``all_gather`` /
    int32 ``all_reduce`` collectives over the mesh axes; masks,
    ``coin_bits`` and the epoch counter are replicated, and the new state's
    rows are gathered so that every rank holds all of it.

    Returns ``step(state, coin_bits, bval_mask=None, aux_mask=None,
    conf_mask=None) -> state``."""
    n, f = aba.n, aba.f
    mine = _node_slice(n, mesh)
    n_axes = mesh.ndim

    def psum(x):
        return _psum(x, mesh)

    def adopt_terms(active, decision, decided):
        for v in (False, True):
            term_cnt = psum((decided & (decision == v)).sum(dim=0))
            adopt = active & (term_cnt >= (f + 1))[None, :] & ~decided
            decision = torch.where(adopt, v, decision)
            decided = decided | adopt
        return decision, decided

    def gathered_state(state, est, decided, decision):
        rows = gather_nodes(torch.stack([est, decided, decision], dim=1), mesh)
        return {
            "est": rows[:, 0], "decided": rows[:, 1], "decision": rows[:, 2],
            "epoch": state["epoch"] + 1,
        }

    def step_full(state, coin_bits):
        est = state["est"][mine]
        decided = state["decided"][mine]
        decision = state["decision"][mine]

        active = ~decided
        val_axis = torch.stack([~est, est], dim=-1)
        term_axis = torch.stack([~decision, decision], dim=-1)
        sent = torch.where(decided[..., None], term_axis, val_axis)

        o, x = sbv_round_model(
            sent, f, SBV_ROUNDS_FULL,
            lambda early: psum(early.sum(dim=0))[None], SBV_INF_FULL,
        )
        binv_j, pref_true = aux_pref_from_crossings(x, SBV_INF_FULL)
        bin_vals = psum(binv_j.any(dim=0)) > 0  # (P, 2)
        aux_val = torch.where(decided, decision, pref_true)
        aux_sent = bin_vals.any(dim=-1)[None] | decided
        aux_v = torch.stack([~aux_val, aux_val], dim=-1) & aux_sent[..., None]
        support = psum((aux_v & bin_vals[None]).any(dim=-1).sum(dim=0))
        vals = bin_vals & (psum(aux_v.sum(dim=0)) > 0)
        sbv_done = support >= (n - f)

        conf = torch.where(decided[..., None], term_axis, vals[None])
        viol = (conf & ~bin_vals[None]).any(dim=-1)
        sent_conf = sbv_done[None] | decided
        conf_done = psum((sent_conf & ~viol).sum(dim=0)) >= (n - f)

        coin = _coin(state["epoch"], coin_bits)
        only_true = vals[:, 1] & ~vals[:, 0]
        vals_single = only_true | (vals[:, 0] & ~vals[:, 1])
        ready = (conf_done & sbv_done)[None] & active
        decide_now = ready & (vals_single & (only_true == coin))[None]
        new_est = torch.where(vals_single, only_true, coin)[None]
        est = torch.where(ready, new_est.expand(est.shape), est)
        decision = torch.where(decide_now, coin[None].expand(est.shape), decision)
        decided = decided | decide_now
        decision, decided = adopt_terms(active, decision, decided)
        return gathered_state(state, est, decided, decision)

    def step_masked(state, coin_bits, bm, am, cm):
        est = state["est"][mine]
        decided = state["decided"][mine]
        decision = state["decision"][mine]
        # receiver slices of the replicated (N_src, N_dst, P) masks
        bm, am, cm = bm[:, mine], am[:, mine], cm[:, mine]

        active = ~decided
        val_axis = torch.stack([~est, est], dim=-1)
        term_axis = torch.stack([~decision, decision], dim=-1)
        sent = torch.where(decided[..., None], term_axis, val_axis)

        INF = sbv_inf_masked(n)
        o, x = sbv_round_model(
            sent, f, sbv_rounds_masked(n),
            lambda early: _count("ipv,ijp->jpv", gather_nodes(early, mesh), bm),
            INF,
        )
        bin_vals, pref_true = aux_pref_from_crossings(x, INF)  # (per, P, 2)
        aux_val = torch.where(decided, decision, pref_true)
        aux_sent = bin_vals.any(dim=-1) | decided
        aux_v = torch.stack([~aux_val, aux_val], dim=-1) & aux_sent[..., None]
        aux_v_full = gather_nodes(aux_v, mesh)  # (N, P, 2)
        support = _count("ipv,ijp,jpv->jp", aux_v_full, am, bin_vals)
        vals = bin_vals & (_count("ipv,ijp->jpv", aux_v_full, am) > 0)
        sbv_done = support >= (n - f)

        conf = torch.where(decided[..., None], term_axis, vals)
        viol = _count("ipv,jpv->ijp", gather_nodes(conf, mesh), ~bin_vals)
        sent_conf_full = gather_nodes(sbv_done | decided, mesh)  # (N, P)
        conf_count = ((viol == 0) & cm & sent_conf_full[:, None, :]).sum(dim=0)
        conf_done = conf_count >= (n - f)

        coin_b = _coin(state["epoch"], coin_bits)[None, :].expand(est.shape)
        only_true = vals[..., 1] & ~vals[..., 0]
        vals_single = only_true | (vals[..., 0] & ~vals[..., 1])
        ready = conf_done & sbv_done & active
        # decisions wait for every active node of the mesh to complete the
        # epoch (the lossy-lockstep guard of BatchedAba.epoch_step)
        incomplete = psum((~((conf_done & sbv_done) | ~active)).sum(dim=0))
        decide_now = ready & vals_single & (only_true == coin_b) & (incomplete == 0)[None]
        est = torch.where(ready, torch.where(vals_single, only_true, coin_b), est)
        decision = torch.where(decide_now, coin_b, decision)
        decided = decided | decide_now
        decision, decided = adopt_terms(active, decision, decided)
        return gathered_state(state, est, decided, decision)

    # static collective counts per step, as the reference accounts them: the
    # SBV round-model reductions plus the aux/conf/term exchanges
    coll_full = (SBV_ROUNDS_FULL + 6) * n_axes
    coll_masked = (sbv_rounds_masked(n) + 6) * n_axes

    def step(state, coin_bits, bval_mask=None, aux_mask=None, conf_mask=None):
        P = state["est"].shape[1]
        dev = state["est"].device
        coin_bits = torch.as_tensor(coin_bits, dtype=torch.bool, device=dev)
        if bval_mask is None and aux_mask is None and conf_mask is None:
            # all_reduce results are (P,)-shaped int32 reductions
            _account("aba", coll_full, (SBV_ROUNDS_FULL + 6) * P * 4)
            return step_full(state, coin_bits)
        # gathered (N, P, 2)-ish bool tensors per round + aux/conf/sent
        _account("aba", coll_masked, (2 * sbv_rounds_masked(n) + 5) * n * P)
        eye = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]

        def mask(m):
            if m is None:
                return torch.ones((n, n, P), dtype=torch.bool, device=dev)
            return torch.as_tensor(m, dtype=torch.bool, device=dev) | eye

        return step_masked(state, coin_bits, mask(bval_mask), mask(aux_mask),
                           mask(conf_mask))

    return step


# ---------------------------------------------------------------------------
# Sharded crypto phases (coin share verification, threshold decryption)
# ---------------------------------------------------------------------------
#
# The protocol rounds above shard the NODE axis; the crypto phases shard the
# ladder ROW axis instead (crypto/batch._MsmCache row-shards its ladders
# when a mesh is attached, gathering the rows before the host fold).  These
# makers pin the per-mesh ladder cache (crypto.batch.cache_for) at build
# time, so the mesh an epoch threads through BatchedAcs and the mesh its
# crypto ladders run on are one object.


def make_sharded_coin_verify(mesh, device="cuda"):
    """Coin/signature share batch verification with the ladders
    row-sharded over ``mesh``: ``verify(pairs, msg, rng) -> bool`` with the
    semantics of ``crypto.batch.batch_verify_sig_shares``.  ``device``
    serves ``mesh=None`` only; a mesh fixes its own."""
    from hbbft_tpu_torch.crypto import batch as _cb

    cache = _cb.cache_for(device, mesh)
    n_axes = mesh.ndim if mesh is not None else 0

    def verify(pairs, msg, rng):
        # two ladder folds (G2 sigs, G1 pks); affine point bytes gathered
        _account("coin", 2 * max(n_axes, 1), len(pairs) * (192 + 96))
        return _cb.batch_verify_sig_shares(pairs, msg, rng, cache=cache)

    return verify


def make_sharded_decrypt(mesh, device="cuda"):
    """Master-scalar threshold decryption with the mask ladder row-sharded
    over ``mesh``: ``decrypt(pks, payloads, secret_shares) -> plaintexts``
    with the semantics of ``crypto.batch.batch_tpke_check_decrypt``
    (ValueError on a malformed payload).  ``device`` as in
    :func:`make_sharded_coin_verify`."""
    from hbbft_tpu_torch.crypto import batch as _cb

    cache = _cb.cache_for(device, mesh)
    n_axes = mesh.ndim if mesh is not None else 0

    def decrypt(pks, payloads, secret_shares):
        # one G1 mask ladder fold; affine G1 bytes per ciphertext
        _account("decrypt", max(n_axes, 1), len(payloads) * 96)
        return _cb.batch_tpke_check_decrypt(pks, payloads, secret_shares, cache=cache)

    return decrypt
