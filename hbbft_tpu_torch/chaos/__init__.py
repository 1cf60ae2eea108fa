"""Chaos engineering for the node stack: link shaping and the campaign.

The port's counterpart of the JAX package's ``chaos/``.
:mod:`hbbft_tpu_torch.chaos.link` makes seeded, per-directed-edge
:class:`LinkPolicy` decisions (latency and jitter, loss, duplication,
reorder, bandwidth caps, timed partitions and heals) behind one shaping
hook, :class:`LinkShaper`, which the simulator (``sim/virtual_net.py``)
and the real socket transport (``net/transport.py``) consume.  The campaign
runner, :mod:`hbbft_tpu_torch.chaos.campaign`, sweeps seeded (scenario ×
topology × adversary) cells, audits every cell's flight journals with
:mod:`hbbft_tpu_torch.obs.audit`, and triages every non-clean verdict to its
first divergent epoch with the spec that replays it.

Every shaping decision comes from the seeded RNG (no wall-clock reads, no
global randomness): the same run replays byte-identically.
"""

from hbbft_tpu_torch.chaos.link import (
    LinkPolicy,
    LinkShaper,
    NetShape,
    PRESETS,
    ShapedLink,
    preset_shape,
)

__all__ = [
    "LinkPolicy", "LinkShaper", "NetShape", "PRESETS", "ShapedLink",
    "preset_shape",
]
