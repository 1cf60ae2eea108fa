"""Chaos engineering for the node stack: link shaping.

The port's counterpart of the JAX package's ``chaos/``, of which
:mod:`hbbft_tpu_torch.chaos.link` is ported: seeded, per-directed-edge
:class:`LinkPolicy` decisions (latency and jitter, loss, duplication,
reorder, bandwidth caps, timed partitions and heals) behind one shaping
hook, :class:`LinkShaper`, which the simulator (``sim/virtual_net.py``)
consumes.  The campaign runner (``chaos/campaign.py``) is not ported yet.

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
