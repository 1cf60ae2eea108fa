"""Byzantine-fault kinds, as far as the port's DKG reports them.

A copy of ``FaultKind`` from the JAX package's ``fault_log.py`` (reference:
``src/fault_log.rs``), cut to the variants ``protocols/sync_key_gen.py``
returns; the fault log and the other protocols' variants are not ported.
"""

from __future__ import annotations

import enum


class FaultKind(enum.Enum):
    """Why a node was logged as faulty (the DKG's variants)."""

    UnknownSender = "message from a node that is not on the network"
    InvalidPart = "sync_key_gen: invalid Part (bad commitment/row)"
    InvalidAck = "sync_key_gen: invalid Ack (bad value)"
