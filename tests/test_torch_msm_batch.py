"""The port's randomized MSM and the batch share checks, on the CPU.

``msm_g1``/``msm_g2`` (the windowed ladder's plain version on CPU tensors,
folded on the host) against the JAX package's host curve; ``rlc_fold_g1``,
``batch_decrypt_share_gen``, ``batch_tpke_decrypt``, ``verify_ciphertext_batch`` and
``verify_dec_share_sets`` against the JAX package's functions on their host
routes, the port's on both routes (the device route forced by its
threshold); ``batch_verify_sig_shares``/``batch_verify_dec_shares``, whose
reference always compiles a ladder, against the per-share host checks,
valid and with one bad share.  Keys and ciphertexts come from the same
seeds in both packages, so they are equal."""

import random

import pytest

from hbbft_tpu.crypto import batch as jb
from hbbft_tpu.crypto import bls12_381 as jc
from hbbft_tpu.crypto import tc as jtc
from hbbft_tpu_torch.crypto import batch as tb
from hbbft_tpu_torch.crypto import tc

MSG = b"coin-epoch-7"
N, T = 6, 2


@pytest.fixture(scope="module")
def keys():
    sks = tc.SecretKeySet.random(T, random.Random(41))
    jsks = jtc.SecretKeySet.random(T, random.Random(41))
    assert sks.public_keys().to_bytes() == jsks.public_keys().to_bytes()
    return sks, jsks


@pytest.fixture(scope="module")
def cts(keys):
    """Three ciphertexts to the key set, the middle one with V altered."""
    pk = keys[0].public_keys().public_key()
    rng = random.Random(42)
    out = [pk.encrypt(b"payload-%d" % i, rng) for i in range(3)]
    out[1] = tc.Ciphertext(out[1].u, b"X" + out[1].v[1:], out[1].w)
    return out


def _j(ct):
    return jtc.Ciphertext.from_bytes(ct.to_bytes())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_msm_matches_host_sum(group):
    rng = random.Random(43 if group == "g1" else 44)
    mul, gen, add, eq = ((jc.g1_mul, jc.G1_GEN, jc.g1_add, jc.g1_eq) if group == "g1"
                         else (jc.g2_mul, jc.G2_GEN, jc.g2_add, jc.g2_eq))
    pts = [mul(gen, rng.randrange(1, jc.R)) for _ in range(4)] + [None]
    rs = [rng.getrandbits(128) | 1 for _ in pts]
    cache = tb.cache_for("cpu")
    got = (cache.msm_g1 if group == "g1" else cache.msm_g2)(pts, rs)
    want = None
    for p, r in zip(pts, rs):
        want = add(want, mul(p, r))
    assert eq(got, want)


def test_rlc_fold_and_share_gen_on_both_routes(keys, cts, monkeypatch):
    sks, _ = keys
    x = sks.secret_key_share(3).scalar
    pts = [ct.u for ct in cts] + [None]
    rs = tb._fs_scalars(b"seed", len(pts))
    assert rs == jb._fs_scalars(b"seed", len(pts))
    want = jb.rlc_fold_g1(pts, rs)  # the JAX package's host route
    want_shares = [s.to_bytes() for s in jb.batch_decrypt_share_gen(x, [_j(ct) for ct in cts])]
    monkeypatch.setattr(tb, "DEVICE_FOLD_MIN_BATCH", None)  # the host routes
    monkeypatch.setattr(tb, "DEVICE_SHARE_GEN_MIN_BATCH", None)
    assert jc.g1_eq(tb.rlc_fold_g1(pts, rs, device="cpu"), want)
    assert [s.to_bytes() for s in tb.batch_decrypt_share_gen(x, cts, device="cpu")] == want_shares
    monkeypatch.setattr(tb, "DEVICE_FOLD_MIN_BATCH", 1)
    monkeypatch.setattr(tb, "DEVICE_SHARE_GEN_MIN_BATCH", 1)
    assert jc.g1_eq(tb.rlc_fold_g1(pts, rs, device="cpu"), want)
    assert [s.to_bytes() for s in tb.batch_decrypt_share_gen(x, cts, device="cpu")] == want_shares


def test_batch_verify_sig_shares(keys):
    sks, _ = keys
    pks = sks.public_keys()
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(MSG)) for i in range(N)]
    assert tb.batch_verify_sig_shares(pairs, MSG, random.Random(45), device="cpu") is True
    forged = list(pairs)
    forged[2] = (pairs[2][0], sks.secret_key_share(2).sign(b"another message"))
    assert [pk.verify(s, MSG) for pk, s in forged] == [True, True, False, True, True, True]
    assert tb.batch_verify_sig_shares(forged, MSG, random.Random(45), device="cpu") is False


def test_batch_verify_dec_shares(keys, cts):
    sks, _ = keys
    pks = sks.public_keys()
    ct = cts[0]
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).decrypt_share(ct, check=False))
             for i in range(N)]
    assert tb.batch_verify_dec_shares(pairs, ct, random.Random(46), device="cpu") is True
    bad = list(pairs)
    bad[4] = (pairs[4][0], tc.DecryptionShare(jc.g1_add(pairs[4][1].point, jc.G1_GEN)))
    assert not bad[4][0].verify_decryption_share(bad[4][1], ct)
    assert tb.batch_verify_dec_shares(bad, ct, random.Random(46), device="cpu") is False


def test_verify_ciphertext_batch(cts):
    want = jb.verify_ciphertext_batch([_j(ct) for ct in cts])
    assert want == [True, False, True]
    assert tb.verify_ciphertext_batch(cts) == want
    assert tb.verify_ciphertext_batch(cts[:1]) == [True]


def test_verify_dec_share_sets(keys, cts, monkeypatch):
    """Two t+1 share sets, the second with one share of the wrong node;
    then the first alone through the forced device fold."""
    sks, jsks = keys
    good, other = cts[0], cts[2]

    def job(pkg_sks, ct, idx, swap=None):
        items = [(i, pkg_sks.secret_key_share(swap if i == idx[-1] and swap else i)
                  .decrypt_share(ct, check=False)) for i in idx]
        return (pkg_sks.public_keys(), items, ct)

    jobs = [job(sks, good, [0, 1, 2]), job(sks, other, [1, 3, 5], swap=4)]
    jjobs = [job(jsks, _j(good), [0, 1, 2]), job(jsks, _j(other), [1, 3, 5], swap=4)]
    want = jb.verify_dec_share_sets(jjobs)
    assert want == [True, False]
    assert tb.verify_dec_share_sets(jobs, device="cpu") == want
    monkeypatch.setattr(tb, "DEVICE_FOLD_MIN_BATCH", 1)
    assert tb.verify_dec_share_sets(jobs[:1], device="cpu") == [True]


def test_tpke_decrypt_on_both_routes(keys, cts, monkeypatch):
    """``batch_tpke_decrypt`` on the host route and forced onto the ladder:
    the JAX package's plaintexts, the altered ciphertext's included."""
    sks, jsks = keys
    shares = [(i, sks.secret_key_share(i)) for i in range(T + 1)]
    jshares = [(i, jsks.secret_key_share(i)) for i in range(T + 1)]
    want = jb.batch_tpke_decrypt(jsks.public_keys(), [_j(ct) for ct in cts], jshares)
    assert want[0] == b"payload-0" and want[2] == b"payload-2"
    pks = sks.public_keys()
    monkeypatch.setattr(tb, "DEVICE_DECRYPT_MIN_BATCH", None)
    assert tb.batch_tpke_decrypt(pks, cts, shares, device="cpu") == want
    monkeypatch.setattr(tb, "DEVICE_DECRYPT_MIN_BATCH", 1)
    assert tb.batch_tpke_decrypt(pks, cts, shares, device="cpu") == want
