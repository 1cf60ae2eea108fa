"""Object mode's device seams on the CPU: the port against the JAX package.

- **The deferred threshold-decrypt seam**: ``HoneyBadger`` with
  ``defer_decrypt = True`` and ``resolve_deferred`` called by hand (as a
  node runtime's pump calls it: ``verify_dec_share_sets`` on the builder's
  device) commits the inline path's batches, and the reference's.
- **The forced device route**: a ``ThresholdDecrypt`` of an N = 22
  network (t + 1 = 8 = ``DEVICE_FOLD_MIN_BATCH``, no net) folds its share
  set on the device route — the plain windowed ladder on the CPU — and
  gives the reference's plaintext, messages and verdicts; a forged share
  among the first t + 1 is faulted as the reference faults it.
- **``rlc_fold_g1`` with scalars past 2^128** (``ThresholdDecrypt``'s
  coefficients are mod r): the device route splits them against the GLV
  eigenvalue and returns the host loop's point.

Tolerance: exact.
"""

import random

import pytest

from test_torch_obj_honey_badger import run_hb
from test_torch_obj_protocols import PORT, REF, canon, infos


@pytest.mark.parametrize("n", [4, 7])
def test_deferred_decrypt_seam_matches_inline(n):
    def batches(p, defer):
        net, _ = run_hb(p, n, "reorder", defer=defer)
        return {nid: [canon(p, o) for o in net.nodes[nid].outputs]
                for nid in net.node_ids()}

    inline = batches(PORT, False)
    deferred = batches(PORT, True)
    assert deferred == inline
    assert deferred == batches(REF, True)
    assert all(len(v) >= 1 for v in inline.values())


@pytest.fixture
def ladder_calls(monkeypatch):
    """Counts the port's windowed-ladder calls (the kernel's wrapper; its
    plain version on the CPU)."""
    from hbbft_tpu_torch.ops import gcurve

    calls = []
    real = gcurve.scalar_mul_lazy_window

    def counted(ops, pt, bits, base_inf):
        calls.append(bits.shape)
        return real(ops, pt, bits, base_inf)

    monkeypatch.setattr(gcurve, "scalar_mul_lazy_window", counted)
    return calls


def _decrypt(p, forge: bool):
    """One node's ``ThresholdDecrypt`` at N = 22 fed the shares of nodes
    1 … 9 (node 5 replaying node 6's share when ``forge``): its steps."""
    n = 22
    nets = infos(p, n, seed=22)
    ct = nets[0].public_key_set().public_key().encrypt(b"object mode" * 5,
                                                       random.Random(9))
    td = p.td.ThresholdDecrypt(nets[0], **p.kw)
    shares = {nid: nets[nid].secret_key_share().decrypt_share(ct, check=False)
              for nid in range(1, 10)}
    if forge:
        shares[5] = shares[6]
    steps = [td.set_ciphertext(ct)]
    for nid, share in shares.items():
        steps.append(td.handle_message(nid, p.td.DecryptionMessage(share)))
    out = [(
        [canon(p, o) for o in s.output],
        [(f.node_id, f.kind.name) for f in s.fault_log],
        [(repr(m.target), p.wire.encode_message(m.message)) for m in s.messages],
    ) for s in steps]
    return out, td.plaintext


@pytest.mark.parametrize("forge", [False, True], ids=["honest", "forged"])
def test_threshold_decrypt_takes_the_device_route(ladder_calls, forge):
    from hbbft_tpu_torch.crypto import batch

    assert batch.DEVICE_FOLD_MIN_BATCH == 8
    ref, ref_plain = _decrypt(REF, forge)
    got, plain = _decrypt(PORT, forge)
    assert plain == ref_plain == b"object mode" * 5
    assert got == ref
    faults = [f for _, fl, _ in got for f in fl]
    assert faults == ([(5, "InvalidDecryptionShare")] if forge else [])
    # two folds a batch check, each one ladder of 2·8 rows (GLV split)
    checks = 2 if forge else 1
    assert len(ladder_calls) == 2 * checks
    assert all(shape[0] == 16 for shape in ladder_calls)


def test_rlc_fold_full_range_scalars_match_the_host(ladder_calls):
    from hbbft_tpu_torch.crypto import batch
    from hbbft_tpu_torch.crypto import bls12_381 as c

    rng = random.Random(4)
    pts = [c.g1_mul(c.G1_GEN, rng.randrange(1, c.R)) for _ in range(8)]
    for scalars in ([rng.randrange(c.R) for _ in range(8)],
                    [rng.getrandbits(128) for _ in range(8)]):
        host = None
        for pt, s in zip(pts, scalars):
            host = c.g1_add(host, c.g1_mul(pt, s))
        assert c.g1_eq(batch.rlc_fold_g1(pts, scalars, device="cpu"), host)
    assert len(ladder_calls) == 2
