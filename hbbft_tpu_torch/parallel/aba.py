"""Batched binary agreement as dense tensor epochs.

Counterpart of ``hbbft_tpu/parallel/aba.py``: one epoch of ALL N nodes × P
instances as tensor ops under the bulk-synchronous model — the per-node
BVal round model (f+1 relay, 2f+1 crossing), Aux support, Conf sets, the
Moumen coin schedule (epochs ≡ 0, 1 mod 3 fixed true/false, else the
threshold coin given as ``coin_bits``), the MMR decision rule and the f+1
Terms rule.  The round-model horizons below must equal the reference's.

Neighbour counts contract in float32 (exact: they never exceed N ≤ 2^24),
since CUDA has no integer ``einsum``.
"""

from __future__ import annotations

import struct
from typing import Dict

import torch

# Round-model horizons (identical to the reference's): full delivery
# reaches the fixpoint in ≤ 2 spread rounds (4 = margin); masked relay
# chains can be ~n hops.
SBV_ROUNDS_FULL = 4
SBV_INF_FULL = 9


def sbv_rounds_masked(n: int) -> int:
    return n + 2


def sbv_inf_masked(n: int) -> int:
    return n + 4


def _count(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """Integer ``einsum`` of 0/1 tensors via exact float32 sums."""
    return torch.einsum(eq, *(o.to(torch.float32) for o in ops)).to(torch.int32)


def sbv_round_model(sent: torch.Tensor, f: int, n_rounds: int, count_fn, inf: int):
    """The per-node BVal round model, shared by both step variants.

    ``sent``: bool (..., 2) initial senders; ``count_fn(early) -> E`` is
    each node's view of |{i : o_i < t}| including its own row.  Returns
    ``(o, x)``: first-send and crossing rounds (``inf`` = never)."""
    o = torch.where(sent, -1, inf).to(torch.int32)
    x = torch.full_like(o, inf)
    for t in range(n_rounds):
        early = (o < t).to(torch.int32)
        E = count_fn(early)
        c0 = E - early + (o <= t).to(torch.int32)
        o = torch.where((c0 >= (f + 1)) & (o == inf), t, o)
        # a round-t relay changes only [o_j ≤ t], so E and early stand
        c1 = E - early + (o <= t).to(torch.int32)
        x = torch.where((c1 >= (2 * f + 1)) & (x == inf), t, x)
    return o, x


def aux_pref_from_crossings(x: torch.Tensor, inf: int):
    """(bin_vals_per_node, pref_true): the earlier-crossing value wins the
    Aux choice, same-round tie → True."""
    binv = x < inf
    pref_true = binv[..., 1] & (~binv[..., 0] | (x[..., 1] <= x[..., 0]))
    return binv, pref_true


def _coin(epoch: torch.Tensor, coin_bits: torch.Tensor) -> torch.Tensor:
    """The Moumen schedule: true on epochs ≡ 0, false on ≡ 1, else the
    threshold coin."""
    m = epoch % 3
    ones = torch.ones_like(coin_bits)
    return torch.where(m == 0, ones, torch.where(m == 1, ~ones, coin_bits))


class BatchedAba:
    """Batched ABA epochs for an (n, f) network, P instances."""

    def __init__(self, n: int, f: int):
        self.n = n
        self.f = f

    def init_state(self, est: torch.Tensor) -> Dict[str, torch.Tensor]:
        """est: bool (N, P) initial estimates → the dense state dict."""
        est = torch.as_tensor(est).bool()
        return {
            "est": est,
            "decided": torch.zeros(est.shape, dtype=torch.bool, device=est.device),
            "decision": torch.zeros(est.shape, dtype=torch.bool, device=est.device),
            "epoch": torch.zeros((), dtype=torch.int32, device=est.device),
        }

    def epoch_step(self, state, coin_bits, bval_mask=None, aux_mask=None,
                   conf_mask=None):
        """One bulk-synchronous ABA epoch for all (node, instance).

        coin_bits: bool (P,) threshold coins (used on random epochs only);
        masks: bool (N_src, N_dst, P) deliveries (default all)."""
        n, f = self.n, self.f
        est = state["est"]
        decided = state["decided"]
        decision = state["decision"]
        P = est.shape[1]
        dev = est.device

        if bval_mask is None and aux_mask is None and conf_mask is None:
            return self._epoch_step_full_delivery(state, coin_bits)

        def mask(m):
            if m is None:
                return torch.ones((n, n, P), dtype=torch.bool, device=dev)
            return torch.as_tensor(m, dtype=torch.bool, device=dev)

        eye = torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]
        bval_mask = mask(bval_mask) | eye
        aux_mask = mask(aux_mask) | eye
        conf_mask = mask(conf_mask) | eye

        # -- SBV: BVal one-hots (N, P, 2); deciders vote their Term --------
        active = ~decided
        val_axis = torch.stack([~est, est], dim=-1)
        term_axis = torch.stack([~decision, decision], dim=-1)
        sent = torch.where(decided[..., None], term_axis, val_axis)

        INF = sbv_inf_masked(n)
        o, x = sbv_round_model(
            sent, f, sbv_rounds_masked(n),
            lambda early: _count("ipv,ijp->jpv", early, bval_mask), INF,
        )
        bin_vals, pref_true = aux_pref_from_crossings(x, INF)

        # -- Aux -----------------------------------------------------------
        has_any = bin_vals.any(dim=-1)
        aux_val = torch.where(decided, decision, pref_true)
        aux_sent = has_any | decided
        aux_v = torch.stack([~aux_val, aux_val], dim=-1) & aux_sent[..., None]
        support = _count("ipv,ijp,jpv->jp", aux_v, aux_mask, bin_vals)
        vals = bin_vals & (_count("ipv,ijp->jpv", aux_v, aux_mask) > 0)
        sbv_done = support >= (n - f)

        # -- Conf: count confs ⊆ receiver's bin_vals -----------------------
        conf = torch.where(decided[..., None], term_axis, vals)
        viol = _count("ipv,jpv->ijp", conf, ~bin_vals)
        sent_conf = sbv_done | decided
        conf_count = ((viol == 0) & conf_mask & sent_conf[:, None, :]).sum(dim=0)
        conf_done = conf_count >= (n - f)

        coin = _coin(state["epoch"], coin_bits)
        coin_b = coin[None, :].expand(est.shape)

        # -- MMR decision rule ---------------------------------------------
        only_true = vals[..., 1] & ~vals[..., 0]
        only_false = vals[..., 0] & ~vals[..., 1]
        vals_single = only_true | only_false
        vals_val = only_true
        ready = conf_done & sbv_done & active
        # decisions wait for every active node to complete the epoch (the
        # reference's guard for the lossy lockstep model)
        all_complete = ((conf_done & sbv_done) | ~active).all(dim=0)
        decide_now = ready & vals_single & (vals_val == coin_b) & all_complete[None]
        new_est = torch.where(vals_single, vals_val, coin_b)
        est = torch.where(ready, new_est, est)
        decision = torch.where(decide_now, coin_b, decision)
        decided = decided | decide_now
        decision, decided = self._adopt_terms(active, decision, decided)
        return {
            "est": est,
            "decided": decided,
            "decision": decision,
            "epoch": state["epoch"] + 1,
        }

    def _adopt_terms(self, active, decision, decided):
        """f+1 Terms rule: laggards adopt a value with f+1 deciders."""
        for v in (False, True):
            term_cnt = (decided & (decision == v)).sum(dim=0)
            adopt = active & (term_cnt >= (self.f + 1))[None, :] & ~decided
            decision = torch.where(adopt, v, decision)
            decided = decided | adopt
        return decision, decided

    def _epoch_step_full_delivery(self, state, coin_bits):
        """Masks-free epoch: every count is the same at every receiver."""
        n, f = self.n, self.f
        est = state["est"]
        decided = state["decided"]
        decision = state["decision"]

        active = ~decided
        val_axis = torch.stack([~est, est], dim=-1)
        term_axis = torch.stack([~decision, decision], dim=-1)
        sent = torch.where(decided[..., None], term_axis, val_axis)

        o, x = sbv_round_model(
            sent, f, SBV_ROUNDS_FULL,
            lambda early: early.sum(dim=0, dtype=torch.int32)[None],
            SBV_INF_FULL,
        )
        binv_j, pref_true = aux_pref_from_crossings(x, SBV_INF_FULL)
        bin_vals = binv_j.any(dim=0)  # (P, 2)
        aux_val = torch.where(decided, decision, pref_true)
        aux_sent = bin_vals.any(dim=-1)[None] | decided
        aux_v = torch.stack([~aux_val, aux_val], dim=-1) & aux_sent[..., None]
        support = (aux_v & bin_vals[None]).any(dim=-1).sum(dim=0)
        vals = bin_vals & (aux_v.sum(dim=0) > 0)
        sbv_done = support >= (n - f)

        conf = torch.where(decided[..., None], term_axis, vals[None])
        viol = (conf & ~bin_vals[None]).any(dim=-1)
        sent_conf = sbv_done[None] | decided
        conf_count = (sent_conf & ~viol).sum(dim=0)
        conf_done = conf_count >= (n - f)

        coin = _coin(state["epoch"], coin_bits)
        only_true = vals[:, 1] & ~vals[:, 0]
        only_false = vals[:, 0] & ~vals[:, 1]
        vals_single = only_true | only_false
        vals_val = only_true
        ready = (conf_done & sbv_done)[None] & active
        decide_now = ready & (vals_single & (vals_val == coin))[None]
        new_est = torch.where(vals_single, vals_val, coin)[None]
        est = torch.where(ready, new_est.expand(est.shape), est)
        coin_b = coin[None].expand(est.shape)
        decision = torch.where(decide_now, coin_b, decision)
        decided = decided | decide_now
        decision, decided = self._adopt_terms(active, decision, decided)
        return {
            "est": est,
            "decided": decided,
            "decision": decision,
            "epoch": state["epoch"] + 1,
        }


# -- threshold coins (host crypto) ---------------------------------------------


def _coin_nonce(session_id: bytes, proposer_id, epoch: int) -> bytes:
    return (
        b"HBBFT-ABA-COIN"
        + struct.pack(">I", len(session_id))
        + session_id
        + repr(proposer_id).encode()
        + struct.pack(">Q", epoch)
    )


def coins_for_epoch(netinfo_map, session_id: bytes, proposer_ids,
                    epoch: int) -> list:
    """:func:`coin_for` over a whole instance axis in ONE native call."""
    from hbbft_tpu_torch.crypto import bls12_381 as c

    nonces = [_coin_nonce(session_id, p, epoch) for p in proposer_ids]
    master = _master_scalar(netinfo_map)
    nat = c._native()
    if nat is not None:
        return nat.bls_coin_batch(master, nonces)
    from hbbft_tpu_torch.crypto import tc

    return [
        tc.Signature(c.g2_mul(c.hash_g2(n), master)).parity() for n in nonces
    ]


def coin_for(netinfo_map, session_id: bytes, proposer_id, epoch: int) -> bool:
    """The threshold-coin value for (instance, epoch): the parity of
    H(nonce)^{f(0)}, which equals the combined signature of any t+1 valid
    shares (Lagrange in the exponent) — the god-view shortcut of the
    reference."""
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.crypto import tc

    nonce = _coin_nonce(session_id, proposer_id, epoch)
    master = _master_scalar(netinfo_map)
    return tc.Signature(c.g2_mul(c.hash_g2(nonce), master)).parity()


_MASTER_CACHE: Dict[int, tuple] = {}
_MASTER_CACHE_MAX = 64


def _master_scalar(netinfo_map) -> int:
    """f(0) interpolated from t+1 secret shares; cached per PublicKeySet
    (the strong reference keeps the id from being recycled)."""
    from hbbft_tpu_torch.crypto import tc

    pks = next(iter(netinfo_map.values())).public_key_set()
    hit = _MASTER_CACHE.get(id(pks))
    if hit is not None and hit[0] is pks:
        return hit[1]
    t = pks.threshold()
    ids = sorted(netinfo_map.keys(), key=repr)
    master = tc.master_secret_from_shares(
        (
            netinfo_map[nid].node_index(nid),
            netinfo_map[nid].secret_key_share().scalar,
        )
        for nid in ids[: t + 1]
    )
    if len(_MASTER_CACHE) >= _MASTER_CACHE_MAX:
        _MASTER_CACHE.clear()
    _MASTER_CACHE[id(pks)] = (pks, master)
    return master
