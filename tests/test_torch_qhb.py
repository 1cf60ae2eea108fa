"""The queueing drivers at small N: the port against the JAX package.

The same seeds go through ``hbbft_tpu.parallel.qhb`` and the port's
``parallel/qhb.py`` with ``device="cpu"`` (AUTO encrypt is native on both
sides).  ``run_to_empty`` must commit the same ledger in the same order in
the same number of epochs; the pipelined run the same set, each
transaction once (which epoch re-proposes what depends on the worker
thread's timing, as in the reference).  A snapshot holds host state only
and continues the same ledger after a restore."""

import io
import pickle
import random

import pytest
import torch

from hbbft_tpu.netinfo import NetworkInfo as JNetworkInfo
from hbbft_tpu.parallel.qhb import BatchedQueueingDynamicHoneyBadger as JQdhb
from hbbft_tpu.parallel.qhb import BatchedQueueingHoneyBadger as JQhb
from hbbft_tpu_torch.netinfo import NetworkInfo
from hbbft_tpu_torch.parallel.qhb import (
    BatchedQueueingDynamicHoneyBadger,
    BatchedQueueingHoneyBadger,
)


def _fill(drv, n, per_node=12):
    pushed = []
    for nid in range(n):
        for j in range(per_node):
            tx = b"tx-%d-%d" % (nid, j)
            drv.push(nid, tx)
            pushed.append(tx)
    return set(pushed)


def _pair(n, seed=3, batch_size=5):
    ref = JQhb(JNetworkInfo.generate_map(list(range(n)), random.Random(seed)),
               batch_size=batch_size)
    got = BatchedQueueingHoneyBadger(
        NetworkInfo.generate_map(list(range(n)), random.Random(seed)),
        batch_size=batch_size, device="cpu")
    return ref, got


def _host_only(obj) -> bytes:
    """``pickle.dumps(obj)``, failing on any tensor in its state."""

    class Pickler(pickle.Pickler):
        def persistent_id(self, o):
            assert not isinstance(o, torch.Tensor), "a snapshot holds a tensor"
            return None

    buf = io.BytesIO()
    Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


@pytest.mark.parametrize("n", [4, 8])
def test_run_to_empty_matches_reference(n):
    ref, got = _pair(n)
    pushed = _fill(ref, n)
    assert _fill(got, n) == pushed
    assert got.run_to_empty(random.Random(5)) == ref.run_to_empty(random.Random(5)) > 1
    assert got.committed == ref.committed  # commit order, not only the set
    assert set(got.committed) == pushed and got.pending() == 0
    assert got.epoch == ref.epoch


def test_pipelined_commits_the_reference_set_once():
    ref, got = _pair(4, seed=4, batch_size=4)
    pushed = _fill(ref, 4)
    _fill(got, 4)
    new_ref = ref.run_epochs_pipelined(random.Random(6), 3)
    new_got = got.run_epochs_pipelined(random.Random(6), 3)
    assert new_got > 0 and new_ref > 0
    ref.run_to_empty(random.Random(7))
    got.run_to_empty(random.Random(7))
    assert len(got.committed) == len(set(got.committed))
    assert set(got.committed) == set(ref.committed) == pushed


def test_queueing_dynamic_matches_reference():
    nets = (JNetworkInfo.generate_map(list(range(4)), random.Random(8)),
            NetworkInfo.generate_map(list(range(4)), random.Random(8)))
    ref = JQdhb(nets[0], batch_size=4, rng=random.Random(9))
    got = BatchedQueueingDynamicHoneyBadger(nets[1], batch_size=4, rng=random.Random(9),
                                            device="cpu")
    pushed = _fill(ref, 4, per_node=6)
    _fill(got, 4, per_node=6)
    assert got.run_to_empty(random.Random(10)) == ref.run_to_empty(random.Random(10))
    assert got.committed == ref.committed and set(got.committed) == pushed
    assert [b.contributions for b in got.dhb.batches] == [b.contributions for b in ref.dhb.batches]


def test_queueing_dynamic_adds_a_validator():
    """Queued transactions and a validator add together (the chip's ``dhb``
    phase at n = 4): the change completes, the new node proposes from its
    own queue, the new key set decrypts, and nothing commits twice."""
    from hbbft_tpu_torch.crypto import tc

    drv = BatchedQueueingDynamicHoneyBadger(
        NetworkInfo.generate_map(list(range(4)), random.Random(5)), batch_size=3,
        rng=random.Random(77), device="cpu")
    pushed = _fill(drv, 5, per_node=6)  # node 4's queue waits for it to join
    rng = random.Random(15)
    drv.run_epoch(rng)
    new_sk = tc.SecretKey.random(random.Random(99))
    for voter in range(4):
        drv.vote_to_add(voter, 4, new_sk.public_key(), secret_key=new_sk)
    for _ in range(6):
        drv.run_epoch(rng)
        if drv.dhb.batches[-1].change.state == "complete":
            break
    assert drv.dhb.batches[-1].change.state == "complete"
    assert drv.dhb.era == 1 and drv.dhb.validators == [0, 1, 2, 3, 4]
    assert drv.run_to_empty(rng) >= 1
    assert len(drv.committed) == len(set(drv.committed)) and set(drv.committed) == pushed
    assert any(tx.startswith(b"tx-4-") for tx in drv.committed)
    dhb = drv.dhb
    pks = dhb.netinfo_map[4].public_key_set()
    ct = pks.public_key().encrypt(b"joined", random.Random(3))
    shares = {i: dhb.netinfo_map[i].secret_key_share().decrypt_share(ct)
              for i in range(pks.threshold() + 1)}
    assert pks.decrypt(shares, ct) == b"joined"


def test_snapshot_restores_and_continues_the_same_ledger():
    drv = BatchedQueueingHoneyBadger(
        NetworkInfo.generate_map(list(range(4)), random.Random(11)), batch_size=4,
        device="cpu")
    pushed = _fill(drv, 4)
    drv.run_epoch(random.Random(12))
    # a snapshot that names the card: it restores here, and runs only once
    # its device is set to the CPU (nothing falls back on its own)
    drv.device = torch.device("cuda")
    blob = _host_only(drv)
    drv.device = torch.device("cpu")
    restored = pickle.loads(blob)
    assert restored.committed == drv.committed and restored.epoch == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            restored.run_epoch(random.Random(13))
    restored = pickle.loads(blob)
    restored.device = torch.device("cpu")
    assert restored.run_to_empty(random.Random(13)) == drv.run_to_empty(random.Random(13))
    assert restored.committed == drv.committed and set(drv.committed) == pushed
    # a pickled, unpickled pipelined run keeps its lock and its ledger
    again = pickle.loads(_host_only(restored))
    assert again.run_epochs_pipelined(random.Random(14), 1) == 0
    assert again.committed == drv.committed


def test_launch_counter_is_exact_under_threads():
    """The pipelined driver launches from two threads: no count is lost."""
    import os
    import sys
    import threading

    from hbbft_tpu_torch import _build

    workers, per_worker = 2 * (os.cpu_count() or 1) + 2, 2000
    saved = dict(_build.LAUNCHES)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        _build.reset_launches()
        threads = [threading.Thread(target=lambda: [_build.count("sha3_256")
                                                    for _ in range(per_worker)])
                   for _ in range(workers)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert _build.LAUNCHES["sha3_256"] == workers * per_worker
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved)
