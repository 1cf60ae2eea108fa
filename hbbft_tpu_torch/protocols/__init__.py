"""The sans-I/O protocol stack (object mode) and its committed types.

Copies of the JAX package's ``protocols/`` modules, with imports re-pointed
at the port's ``crypto/``, ``ops/``, ``netinfo.py``, ``traits.py`` and
``fault_log.py``:

- ``broadcast`` (RBC), ``binary_agreement`` (ABA), ``subset`` (ACS),
  ``threshold_sign`` (the common coin), ``threshold_decrypt``;
- ``honey_badger``, ``dynamic_honey_badger``, ``queueing_honey_badger``,
  each with its builder; the builders' ``device`` (default ``"cuda"``,
  raising without a card) reaches every ``crypto/batch.py`` call and the
  ``device`` erasure backend of ``ops/rs.py``;
- ``sync_key_gen`` (the DKG), ``wire`` (the canonical codec and the
  message registry);
- ``sender_queue`` (the per-peer epoch-gated buffering every node stack
  sits behind) and ``vid`` (verifiable information dispersal: the
  dispersal, its certificates and ``VidQueueingHoneyBadger``; the
  ``Disperser`` encodes on its ``device``).

The array-mode drivers of ``parallel/`` use the committed types
(``EncryptionSchedule``, the DHB votes and key-gen messages, ``DhbBatch``,
``JoinPlan``, ``TransactionQueue``).  This package imports nothing itself.
"""
