"""The port's SHA3-256 (plain version, the CPU side of Kernel 2) and Merkle
tree functions against the JAX package and hashlib, exactly."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hbbft_tpu.ops import keccak as jk
from hbbft_tpu.ops import merkle as jm
from hbbft_tpu_torch.ops import keccak as tk
from hbbft_tpu_torch.ops import merkle as tm


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 300])
def test_sha3_matches_jax_and_hashlib(length):
    msgs = np.random.default_rng(length).integers(0, 256, (2, 3, length), dtype=np.uint8)
    got = tk.sha3_256(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(got, np.asarray(jax.jit(jk.sha3_256)(jnp.asarray(msgs))))
    for i in range(2):
        for j in range(3):
            assert got[i, j].tobytes() == hashlib.sha3_256(msgs[i, j].tobytes()).digest()


def test_spec_tables_match_jax():
    assert tk.ROUND_CONSTANTS == jk.ROUND_CONSTANTS
    assert np.array_equal(tk._PI_SRC, jk._PI_SRC)
    assert np.array_equal(tk._PI_ROT, jk._PI_ROT)


def _jax_build_root_verify(leaves, vals, idx, flip):
    """The three JAX tree functions in one jit (one compile per n): build,
    root, and verify of ``vals`` against the built root with the proofs
    XORed by ``flip``."""
    jroot, jproofs, jmask = jm.merkle_build_jax(leaves)
    ok = jm.merkle_verify_jax(vals, idx, jroot[:, None, :], jproofs ^ flip, jmask[None])
    return jroot, jproofs, jmask, jm.merkle_root_jax(leaves), ok


@pytest.mark.parametrize("n", [4, 5, 16])
def test_merkle_build_root_verify_match_jax(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (2, n, 24), dtype=np.uint8)
    # verify: honest proofs pass; a flipped value byte and a flipped proof
    # digest fail — identically in both implementations
    vals = leaves.copy()
    vals[1, n // 2, 3] ^= 1
    idx = np.broadcast_to(np.arange(n, dtype=np.int32)[None], (2, n)).copy()
    root, proofs, mask = tm.merkle_build(torch.from_numpy(leaves))
    flip = np.zeros(tuple(proofs.shape), dtype=np.uint8)
    flip[0, 1, 0, 5] = 0x80
    jroot, jproofs, jmask, jroot2, ref = jax.jit(_jax_build_root_verify)(
        jnp.asarray(leaves), jnp.asarray(vals), jnp.asarray(idx), jnp.asarray(flip)
    )
    assert np.array_equal(root.numpy(), np.asarray(jroot))
    assert np.array_equal(proofs.numpy(), np.asarray(jproofs))
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert np.array_equal(tm.merkle_root(torch.from_numpy(leaves)).numpy(), np.asarray(jroot2))
    # the object-mode tree agrees on the root
    assert root[0].numpy().tobytes() == jm.MerkleTree(
        [leaves[0, i].tobytes() for i in range(n)]
    ).root_hash()

    got = tm.merkle_verify(
        torch.from_numpy(vals), torch.from_numpy(idx), root[:, None, :],
        torch.from_numpy(np.asarray(jproofs) ^ flip), mask[None],
    ).numpy()
    assert np.array_equal(got, np.asarray(ref))
    assert not got[1, n // 2] and not got[0, 1] and got.sum() == 2 * n - 2
