"""Static per-run membership and key material.

Mirrors the reference's ``src/netinfo.rs :: NetworkInfo``: one immutable
object, shared by every protocol instance of a node, holding the sorted
validator set, the BFT fault bound f = ⌊(n−1)/3⌋, the threshold public key
set, per-node threshold public key shares, this node's secret key share (only
validators have one), plus plain per-node keypairs used for message-level
signatures (DynamicHoneyBadger votes, SyncKeyGen row encryption).
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Mapping, Optional, Sequence

NodeId = Hashable


class NetworkInfo:
    """Reference: ``src/netinfo.rs :: NetworkInfo``."""

    def __init__(
        self,
        our_id: NodeId,
        public_keys: Mapping[NodeId, Any],
        public_key_set: Any,
        secret_key_share: Optional[Any] = None,
        secret_key: Optional[Any] = None,
    ):
        self._our_id = our_id
        # Deterministic global node ordering: sort by repr-stable key.  The
        # reference uses BTreeMap<N, _> ordering; we sort the ids themselves.
        self._all_ids: List[NodeId] = sorted(public_keys.keys())
        self._public_keys: Dict[NodeId, Any] = dict(public_keys)
        self._public_key_set = public_key_set
        self._secret_key_share = secret_key_share
        self._secret_key = secret_key
        self._index: Dict[NodeId, int] = {n: i for i, n in enumerate(self._all_ids)}
        n = len(self._all_ids)
        self._num_faulty = (n - 1) // 3 if n > 0 else 0

    def _peer(self, our_id: NodeId, secret_key_share=None, secret_key=None) -> "NetworkInfo":
        """The NetworkInfo of another node of this network: the same (never
        mutated) id list, index and key tables, shared rather than copied,
        so that a map of N nodes holds them once instead of N times."""
        peer = object.__new__(NetworkInfo)
        peer.__dict__.update(self.__dict__)
        peer._our_id = our_id
        peer._secret_key_share = secret_key_share
        peer._secret_key = secret_key
        return peer

    # -- membership --------------------------------------------------------
    def our_id(self) -> NodeId:
        return self._our_id

    def all_ids(self) -> List[NodeId]:
        return self._all_ids

    def num_nodes(self) -> int:
        return len(self._all_ids)

    def num_faulty(self) -> int:
        """f = ⌊(n−1)/3⌋ — the maximum tolerated Byzantine count."""
        return self._num_faulty

    def num_correct(self) -> int:
        return self.num_nodes() - self.num_faulty()

    def node_index(self, node_id: NodeId) -> Optional[int]:
        return self._index.get(node_id)

    def is_node_validator(self, node_id: NodeId) -> bool:
        return node_id in self._index

    def is_validator(self) -> bool:
        return self._our_id in self._index and self._secret_key_share is not None

    # -- key material ------------------------------------------------------
    def public_key_set(self):
        return self._public_key_set

    def public_key_share(self, node_id: NodeId):
        idx = self.node_index(node_id)
        if idx is None:
            return None
        return self._public_key_set.public_key_share(idx)

    def secret_key_share(self):
        return self._secret_key_share

    def secret_key(self):
        return self._secret_key

    def public_key(self, node_id: NodeId):
        return self._public_keys.get(node_id)

    def public_key_map(self) -> Dict[NodeId, Any]:
        return dict(self._public_keys)

    # -- test helper -------------------------------------------------------
    @staticmethod
    def generate_map(ids: Sequence[NodeId], rng) -> Dict[NodeId, "NetworkInfo"]:
        """Generate a full validator network's key material for tests.

        Reference analog: ``NetworkInfo::generate_map`` (test utility).
        Returns one NetworkInfo per id, all sharing a fresh
        ``SecretKeySet.random(f, rng)`` with threshold f = ⌊(n−1)/3⌋.
        """
        from hbbft_tpu_torch.crypto import tc

        ids = sorted(ids)
        f = (len(ids) - 1) // 3
        sk_set = tc.SecretKeySet.random(f, rng)
        sec_keys = {nid: tc.SecretKey.random(rng).scalar for nid in ids}
        return netinfo_map_from_plain(ids, sk_set.poly.coeffs, sec_keys)


def netinfo_map_from_plain(
    ids: Sequence[NodeId],
    poly_coeffs: Sequence[int],
    node_secret_keys: Mapping[NodeId, int],
) -> Dict[NodeId, NetworkInfo]:
    """Rebuild a validator network from its plain key material.

    ``poly_coeffs`` are the threshold polynomial's coefficients over Fr
    (constant term first) and ``node_secret_keys`` maps each id to its plain
    BLS secret scalar — everything :meth:`NetworkInfo.generate_map` draws.
    The result is key-for-key the network that produced those ints, so a
    network made elsewhere carries across as Python ints alone.
    """
    from hbbft_tpu_torch.crypto import tc

    ids = sorted(ids)
    sk_set = tc.SecretKeySet(tc.Poly(poly_coeffs))
    pk_set = sk_set.public_keys()
    sec_keys = {nid: tc.SecretKey(node_secret_keys[nid]) for nid in ids}
    pub_keys = {nid: sk.public_key() for nid, sk in sec_keys.items()}
    if not ids:
        return {}
    shares = sk_set.secret_key_shares(len(ids))
    first = NetworkInfo(our_id=ids[0], public_keys=pub_keys, public_key_set=pk_set,
                        secret_key_share=shares[0], secret_key=sec_keys[ids[0]])
    return {nid: first._peer(nid, shares[i], sec_keys[nid]) for i, nid in enumerate(ids)}
