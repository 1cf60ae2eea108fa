"""Object mode's host Merkle trees: the port against the JAX package.

``ops/merkle.py``'s ``MerkleTree`` (hashlib leaves below
``_BATCH_MIN_BYTES``, the native oracle's batch hasher from there; odd
carries at every level) and ``Proof.validate`` against the reference's:
roots and every proof equal for 1 … 33 leaves of short and long values,
``from_shards`` equal to ``from_vec``, and the verdicts of honest and
tampered proofs equal.  Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

from hbbft_tpu.ops import merkle as jmerkle
from hbbft_tpu_torch.ops import merkle


def _leaves(n, size):
    rng = np.random.default_rng(n * 1000 + size)
    return [rng.integers(0, 256, size, dtype=np.uint8).tobytes() for _ in range(n)]


def _proof_tuple(pr):
    return (bytes(pr.value), pr.index, pr.root_hash, pr.path)


@pytest.mark.parametrize("size", [7, 200])
def test_roots_and_proofs_match_reference(size):
    for n in range(1, 34):
        leaves = _leaves(n, size)
        got, want = merkle.MerkleTree(leaves), jmerkle.MerkleTree(leaves)
        assert got.root_hash() == want.root_hash()
        assert got.levels == want.levels
        for i in range(n):
            assert _proof_tuple(got.proof(i)) == _proof_tuple(want.proof(i))
            assert got.proof(i).validate(n)
        assert got.proof(n) is None and got.proof(-1) is None
        arr = np.frombuffer(b"".join(leaves), dtype=np.uint8).reshape(n, size)
        shard_tree = merkle.MerkleTree.from_shards(arr, [memoryview(v) for v in leaves])
        assert shard_tree.levels == got.levels


def _tampered(p, n):
    """Honest and tampered variants of proof 3 of an n-leaf tree."""
    mod = merkle if p == "port" else jmerkle
    tree = mod.MerkleTree(_leaves(n, 64))
    pr = tree.proof(3)
    sib, left = pr.path[0]
    flip = bytes([sib[0] ^ 1]) + sib[1:]
    return [
        (pr, n),
        (pr, n + 1),
        (pr, n - 1),
        (dataclasses.replace(pr, value=pr.value[:-1] + b"\x00"), n),
        (dataclasses.replace(pr, index=2), n),
        (dataclasses.replace(pr, index=n + 5), n),
        (dataclasses.replace(pr, path=((flip, left),) + pr.path[1:]), n),
        (dataclasses.replace(pr, path=((sib, not left),) + pr.path[1:]), n),
        (dataclasses.replace(pr, path=pr.path[:-1]), n),
        (dataclasses.replace(pr, path=pr.path + pr.path[:1]), n),
        (dataclasses.replace(pr, root_hash=bytes(32)), n),
    ]


@pytest.mark.parametrize("n", [4, 5, 7, 16, 22])
def test_validate_verdicts_match_reference(n):
    got = [pr.validate(m) for pr, m in _tampered("port", n)]
    want = [pr.validate(m) for pr, m in _tampered("ref", n)]
    assert got == want
    assert got[0] and not any(got[3:])
