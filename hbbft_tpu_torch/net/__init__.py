"""The node stack's network-side services.

The port's counterpart of the JAX package's ``net/``, of which only
``retrieve`` (VID's fetch-and-reconstruct service and its shard store) is
ported so far.  The reference's package also holds the socket transport
and the node runtime, and its ``__init__`` imports them; this one exports
only what is ported.
"""

from hbbft_tpu_torch.net.retrieve import (
    RetrievedPayload,
    RetrieveService,
    ShardStore,
)

__all__ = ["RetrievedPayload", "RetrieveService", "ShardStore"]
