"""The erasure coder's host API: the port against the JAX package.

``ops/rs.py``'s ``encode_np`` / ``encode_into`` / ``reconstruct_np`` /
``reconstruct_data_np`` under each value of ``HBBFT_ERASURE_BACKEND`` —
``native`` (the oracle's SIMD tables), ``numpy`` (the cached XOR schedule)
and ``device`` (the bit-plane product on ``device="cpu"``; the reference's
``jax``) — against the reference's coder at (N, f) = (4, 1), (7, 2),
(16, 5), (64, 21) over GF(2^8) and at 300 shards over GF(2^16), with
erasures up to 2f; the XOR schedule itself, and the per-backend ``STATS``.

Tolerance: exact, byte for byte.
"""

import random

import numpy as np
import pytest

from hbbft_tpu.ops import gf256 as jgf256
from hbbft_tpu.ops import rs as jrs
from hbbft_tpu_torch.ops import gf256, rs

BACKENDS = ("native", "numpy", "device")
SHAPES = [(4, 1), (7, 2), (16, 5), (64, 21)]


def _data(k, B, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, B), dtype=np.uint8)


def _erase(shards, f, seed):
    """Erase 2f of the shards (the most a decode tolerates)."""
    out = [bytes(s) for s in shards]
    for i in random.Random(seed).sample(range(len(out)), 2 * f):
        out[i] = None
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,f", SHAPES)
def test_gf256_coder_bytes_match_reference(monkeypatch, backend, n, f):
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "auto")
    ref = jrs.for_n_f(n, f)
    data = _data(n - 2 * f, 2 * 331, seed=n)
    want = ref.encode_np(data)
    erased = _erase(want, f, seed=n + 1)
    want_full = ref.reconstruct_np(erased)
    use = tuple(i for i, s in enumerate(erased) if s is not None)[: n - 2 * f]

    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", backend)
    assert rs.resolve_backend() == backend
    coder = rs.for_n_f(n, f)
    before = rs.stats_snapshot()[backend]
    got = coder.encode_np(data, device="cpu")
    assert np.array_equal(got, want)
    buf = np.zeros_like(want)
    buf[: n - 2 * f] = data
    assert np.array_equal(coder.encode_into(buf, device="cpu"), want)
    assert coder.reconstruct_np(erased, device="cpu") == want_full
    surv = np.stack([np.frombuffer(erased[i], dtype=np.uint8) for i in use])
    assert np.array_equal(coder.reconstruct_data_np(surv, use, device="cpu"), data)
    after = rs.stats_snapshot()[backend]
    assert after["calls"] > before["calls"] and after["bytes"] > before["bytes"]


@pytest.fixture(scope="module")
def rs16_pair():
    return jrs.for_n_f(300, 99), rs.for_n_f(300, 99)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gf16_coder_bytes_match_reference(monkeypatch, rs16_pair, backend):
    ref, coder = rs16_pair
    assert isinstance(coder, rs.ReedSolomon16)
    data = _data(102, 2 * 23, seed=300)
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "numpy")
    want = ref.encode_np(data)
    erased = _erase(want, 99, seed=301)
    want_full = ref.reconstruct_np(erased)

    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", backend)
    buf = np.zeros_like(want)
    buf[:102] = data
    assert np.array_equal(coder.encode_into(buf, device="cpu"), want)
    assert coder.reconstruct_np(erased, device="cpu") == want_full
    # the GF(2^8)-only native kernel routes to numpy, as the reference's
    counted = "numpy" if backend == "native" else backend
    before = rs.stats_snapshot()[counted]["calls"]
    use = tuple(i for i, s in enumerate(erased) if s is not None)[:102]
    surv = np.stack([np.frombuffer(erased[i], dtype=np.uint8) for i in use])
    assert np.array_equal(coder.reconstruct_data_np(surv, use, device="cpu"), data)
    assert rs.stats_snapshot()[counted]["calls"] == before + 1


@pytest.mark.parametrize("n,f", SHAPES[:3])
def test_xor_schedule_matches_reference(n, f):
    bits = gf256.gf_matrix_to_bits(rs.for_n_f(n, f).parity_matrix)
    got, want = gf256.build_xor_schedule(bits), jgf256.build_xor_schedule(bits)
    assert (got.n_in, got.ops, got.outputs, got.xor_count) == (
        want.n_in, want.ops, want.outputs, want.xor_count)
    data = _data(n - 2 * f, 5000, seed=f)
    assert np.array_equal(gf256.apply_xor_schedule(got, data, tile_bytes=1 << 10),
                          jgf256.apply_xor_schedule(want, data))
    assert gf256.gf_div(7, 3) == jgf256.gf_div(7, 3)


def test_xor_schedule_matches_reference_on_random_matrices():
    """The port's incremental greedy CSE picks the reference's pair at
    every step, ties included (dense and sparse bit matrices)."""
    rng = np.random.default_rng(5)
    for _ in range(40):
        k, r = int(rng.integers(1, 7)), int(rng.integers(1, 6))
        bits = (rng.random((8 * k, 8 * r)) < rng.random()).astype(np.int8)
        got, want = gf256.build_xor_schedule(bits), jgf256.build_xor_schedule(bits)
        assert (got.ops, got.outputs) == (want.ops, want.outputs)


def test_unknown_backend_and_reconstruct_errors(monkeypatch):
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "jax")
    with pytest.raises(ValueError, match="HBBFT_ERASURE_BACKEND"):
        rs.resolve_backend()
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "numpy")
    coder = rs.for_n_f(4, 1)
    shards = [bytes(4)] + [None] * 3
    with pytest.raises(ValueError, match="too few shards"):
        coder.reconstruct_np(shards, device="cpu")
    with pytest.raises(ValueError, match="wrong shard count"):
        coder.reconstruct_np([bytes(4)] * 3, device="cpu")
    with pytest.raises(ValueError, match="inconsistent"):
        coder.reconstruct_np([bytes(4), bytes(6), None, None], device="cpu")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,f", SHAPES[:2])
def test_verify_np_matches_reference(monkeypatch, backend, n, f):
    """``verify_np``: True on a codeword, False once any shard's byte
    flips, as the reference's."""
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "auto")
    ref = jrs.for_n_f(n, f)
    shards = ref.encode_np(_data(n - 2 * f, 96, seed=7 * n))
    cases = [shards]
    for row in (0, n - 1):
        bad = shards.copy()
        bad[row, 5] ^= 0x40
        cases.append(bad)
    want = [ref.verify_np(c) for c in cases]
    assert want == [True, False, False]
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", backend)
    assert [rs.for_n_f(n, f).verify_np(c, device="cpu") for c in cases] == want


def test_lru_len_and_contains_match_reference():
    """The per-coder cache's ``len`` and ``in`` follow its evictions and
    refreshes as the reference's do."""
    ops = [("put", k) for k in range(5)] + [("get", 2), ("put", 9), ("get", 0), ("put", 7)]

    def trace(lru_cls):
        lru, out = lru_cls(maxsize=4), []
        for op, k in ops:
            if op == "put":
                lru.put(k, ("v", k))
            else:
                lru.get(k)
            out.append((len(lru), [j for j in range(10) if j in lru]))
        return out

    got = trace(rs._Lru)
    assert got == trace(jrs._Lru)
    assert got[-1] == (4, [2, 4, 7, 9])
