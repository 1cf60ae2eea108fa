"""Host protocol types that the multi-epoch drivers of ``parallel/`` need.

Copies of the JAX package's ``protocols/`` modules, cut to the least set
``parallel/qhb.py`` and ``parallel/dhb.py`` use, with imports re-pointed at
the port's ``crypto/tc.py``, ``crypto/bls12_381.py``, ``netinfo.py`` and
``crypto/batch.py``:

- ``wire`` — the canonical byte codec of what rides in a contribution;
- ``sync_key_gen`` — the DKG (``SyncKeyGen``, ``Part``, ``Ack``), its
  commitment checks on the device ladder above the batch thresholds;
- ``honey_badger`` — ``EncryptionSchedule``;
- ``dynamic_honey_badger`` — votes, signed key-gen messages, the internal
  contribution, ``DhbBatch`` and ``JoinPlan``;
- ``queueing_honey_badger`` — ``TransactionQueue`` and its tx codec.

The object-mode state machines (broadcast, binary agreement, subset, the
message registry) are not ported.  This package imports nothing itself.
"""
