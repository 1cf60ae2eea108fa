"""The SHA3 kernel's thread split against hashlib and the plain version, on
the CPU.

``csrc/keccak.cu`` runs only on the card: two neighbouring threads hold the
low and high 32-bit halves of one message's 25 lanes, a 64-bit rotation is
an exchange with the partner (``__shfl_xor_sync(…, 1)``) and one funnel
shift, and each 136-byte block is staged word by word with the FIPS-202
padding applied on the way.  Here a model of that — the pair of threads as
an axis of size 2, the exchange as a flip of that axis — runs the kernel's
staging, absorb, rounds and squeeze and is held byte-exact against
``hashlib.sha3_256`` and ``sha3_256_plain``.
"""

import hashlib

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.ops import keccak

RATE, RATE_WORDS = 136, 34
M32 = np.uint64(0xFFFFFFFF)
ROT = [1, 3, 6, 10, 15, 21, 28, 36, 45, 55, 2, 14,
       27, 41, 56, 8, 25, 43, 62, 18, 39, 61, 20, 44]
PI = [10, 7, 11, 17, 18, 3, 5, 16, 8, 21, 24, 4,
      15, 23, 19, 13, 12, 2, 20, 14, 22, 9, 6, 1]
# kRoundConstants: (low, high) halves, the thread with h = 1 reads the high
RC = np.array([[c & 0xFFFFFFFF, c >> 32] for c in keccak.ROUND_CONSTANTS],
              dtype=np.uint64)


def funnelshift_l(lo, hi, s):
    """__funnelshift_l(lo, hi, s): the high word of (hi:lo) << (s & 31)."""
    s &= 31
    if s == 0:
        return hi
    return ((hi << np.uint64(s)) | (lo >> np.uint64(32 - s))) & M32


def rotl_half(v, r):
    """Each thread's half of rotl64 by r; v: (2, M), thread h on axis 0."""
    if r == 0:
        return v
    u = v[::-1]  # __shfl_xor_sync(kFull, v, 1)
    return funnelshift_l(u, v, r) if r < 32 else funnelshift_l(v, u, r - 32)


def keccak_f1600(st):
    """keccak.cu's round loop on (25, 2, M) halves."""
    h = np.arange(2)[:, None]
    for rnd in range(24):
        bc = [st[x] ^ st[x + 5] ^ st[x + 10] ^ st[x + 15] ^ st[x + 20] for x in range(5)]
        rot1 = [rotl_half(bc[x], 1) for x in range(5)]
        for x in range(5):
            d = bc[(x + 4) % 5] ^ rot1[(x + 1) % 5]
            for y in range(0, 25, 5):
                st[y + x] ^= d
        t = st[1].copy()
        for i in range(24):
            keep = st[PI[i]].copy()
            st[PI[i]] = rotl_half(t, ROT[i])
            t = keep
        for y in range(0, 25, 5):
            row = [st[y + x].copy() for x in range(5)]
            for x in range(5):
                st[y + x] = row[x] ^ (~row[(x + 1) % 5] & M32 & row[(x + 2) % 5])
        st[0] ^= RC[rnd][h]
    return st


def stage(msgs, b, nblocks, aligned=True):
    """keccak.cu's ``stage``: block b of every message as 34 words, 4-byte
    loads where the length allows and bytes with the padding elsewhere."""
    M, n = msgs.shape
    words = aligned and n % 4 == 0
    last = RATE * nblocks - 1
    out = np.zeros((M, RATE_WORDS), dtype=np.uint64)
    for w in range(RATE_WORDS):
        k0 = RATE * b + 4 * w
        if words and k0 + 4 <= n:
            out[:, w] = msgs[:, k0: k0 + 4].astype(np.uint64) @ (
                np.uint64(1) << np.arange(0, 32, 8, dtype=np.uint64))
            continue
        word = np.zeros(M, dtype=np.uint64)
        for k in range(4):
            pos = k0 + k
            byte = msgs[:, pos].astype(np.uint64) if pos < n else np.zeros(M, np.uint64)
            if pos == n:
                byte ^= np.uint64(0x06)
            if pos == last:
                byte ^= np.uint64(0x80)
            word |= byte << np.uint64(8 * k)
        out[:, w] = word
    return out


def sha3_pairs(msgs, aligned=True):
    """The kernel's whole message loop on uint8 (M, n) → (M, 32)."""
    M, n = msgs.shape
    nblocks = n // RATE + 1
    st = np.zeros((25, 2, M), dtype=np.uint64)
    for b in range(nblocks):
        blk = stage(msgs, b, nblocks, aligned)  # (M, 34)
        for lane in range(RATE // 8):  # thread h takes word 2·lane + h
            st[lane] ^= np.stack([blk[:, 2 * lane], blk[:, 2 * lane + 1]])
        st = keccak_f1600(st)
    # o[2l + h] = st[l] on thread h: little-endian words
    words = np.stack([st[lane][hh] for lane in range(4) for hh in range(2)], axis=1)
    return (words[..., None] >> (np.uint64(8) * np.arange(4, dtype=np.uint64))
            & np.uint64(0xFF)).astype(np.uint8).reshape(M, 32)


def test_pair_rotation_is_the_64_bit_rotation():
    rng = np.random.default_rng(70)
    x = rng.integers(0, 1 << 63, 64, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    pair = np.stack([x & M32, x >> np.uint64(32)])
    for r in range(64):
        got = rotl_half(pair, r)
        want = ((x << np.uint64(r)) | (x >> np.uint64((64 - r) % 64))) if r else x
        assert np.array_equal(got[0] | (got[1] << np.uint64(32)), want)


@pytest.mark.parametrize("length", [0, 1, 135, 136, 137, 2924])
def test_thread_split_matches_hashlib_and_plain(length):
    rng = np.random.default_rng(71 + length)
    msgs = rng.integers(0, 256, (3, length), dtype=np.uint8)
    got = sha3_pairs(msgs)
    for i in range(3):
        assert got[i].tobytes() == hashlib.sha3_256(msgs[i].tobytes()).digest()
    plain = keccak.sha3_256_plain(torch.from_numpy(msgs)).numpy()
    assert np.array_equal(got, plain)


@pytest.mark.parametrize("length", [64, 272])
def test_thread_split_byte_path_matches_word_path(length):
    """An unaligned base takes the byte path for every word: same digest."""
    rng = np.random.default_rng(72)
    msgs = rng.integers(0, 256, (2, length), dtype=np.uint8)
    assert np.array_equal(sha3_pairs(msgs, aligned=False), sha3_pairs(msgs))
