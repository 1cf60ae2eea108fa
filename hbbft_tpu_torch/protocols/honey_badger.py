"""HoneyBadger's encryption schedule.

A copy of ``EncryptionSchedule`` from the JAX package's
``protocols/honey_badger.py`` (reference: ``EncryptionSchedule``); the
object-mode ``HoneyBadger`` is not ported.
"""

from __future__ import annotations


class EncryptionSchedule:
    """When to TPKE-encrypt contributions.

    Reference variants: ``Always``, ``Never``, ``EveryNthEpoch(n)``,
    ``TickTock(on, off)``.
    """

    def __init__(self, kind: str, a: int = 0, b: int = 0):
        self.kind = kind
        self.a = a
        self.b = b

    @classmethod
    def always(cls):
        return cls("always")

    @classmethod
    def never(cls):
        return cls("never")

    @classmethod
    def every_nth_epoch(cls, n: int):
        return cls("nth", n)

    @classmethod
    def tick_tock(cls, on: int, off: int):
        return cls("ticktock", on, off)

    def encrypt_on_epoch(self, epoch: int) -> bool:
        if self.kind == "always":
            return True
        if self.kind == "never":
            return False
        if self.kind == "nth":
            return epoch % self.a == 0
        period = self.a + self.b
        return (epoch % period) < self.a
