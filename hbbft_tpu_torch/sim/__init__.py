"""Object-mode deterministic network simulation (reference: ``tests/net/``).

The port's copy of the JAX package's ``sim/``: ``VirtualNet`` is the
message-pump event loop the sans-I/O protocols need — a queue of in-flight
messages, an :class:`~hbbft_tpu_torch.sim.adversary.Adversary` that
chooses/tampers delivery, and ``crank()`` delivering exactly one message at
a time; ``NetBuilder.shape`` adds link shaping (``chaos/link.py``).  Fully
deterministic from a seed.  The batched drivers of ``parallel/`` replace
this loop with one device step per communication round; this harness is the
semantic ground truth they are checked against.
"""

from hbbft_tpu_torch.sim.adversary import (
    Adversary,
    CensorshipAdversary,
    CrashAtEpochAdversary,
    EclipseAdversary,
    EquivocatingAdversary,
    FloodAdversary,
    FutureEpochSpamAdversary,
    MitmDelayAdversary,
    NodeOrderAdversary,
    NullAdversary,
    RandomAdversary,
    ReorderingAdversary,
    SpoofReplayAdversary,
    TargetedDelayAdversary,
    VoteStormAdversary,
)
from hbbft_tpu_torch.sim.trace import CostModel, CrankEvent, EventLog, NetEvent
from hbbft_tpu_torch.sim.virtual_net import CrankError, NetBuilder, VirtualNet
