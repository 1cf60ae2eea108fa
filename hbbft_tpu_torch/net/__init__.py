"""Real async networking for the sans-I/O consensus stack.

The port's copy of the JAX package's ``net/``.  Layering (bottom up):

- :mod:`~hbbft_tpu_torch.net.framing` — length-prefixed, size-capped frames
  over the :mod:`hbbft_tpu_torch.protocols.wire` codec, with a versioned
  hello;
- :mod:`~hbbft_tpu_torch.net.transport` — asyncio TCP peer connections:
  per-peer persistent outbound queues, seeded deterministic exponential
  backoff, heartbeats and dead-peer detection;
- :mod:`~hbbft_tpu_torch.net.runtime` — :class:`NodeRuntime` hosts any
  ``SenderQueue``-wrappable :class:`~hbbft_tpu_torch.traits.ConsensusProtocol`
  behind sockets, resolving ``Target`` routing and driving the
  ``EpochStarted`` catch-up path for lagging/restarted peers; its pump
  hands every threshold-decrypt share set in flight to
  ``crypto/batch.py``'s ``verify_dec_share_sets`` on the node's ``device``;
- :mod:`~hbbft_tpu_torch.net.retrieve` — VID's fetch-and-reconstruct
  service and its shard store;
- :mod:`~hbbft_tpu_torch.net.client` — bounded dedup'd mempool (node side)
  and the :class:`ClusterClient` contribute frontend with backpressure and
  submit→commit latency tracking;
- :mod:`~hbbft_tpu_torch.net.cluster` — cluster assembly: in-process
  :class:`LocalCluster` and per-node subprocess entry
  (``python -m hbbft_tpu_torch.net.cluster``), with a ``device`` (default
  ``"cuda"``, raising without a card).

Beside the layers, at the operator's edge:
:mod:`~hbbft_tpu_torch.net.gateway` terminates client connections off the
consensus path and multiplexes them into a few authenticated node links;
:mod:`~hbbft_tpu_torch.net.loadgen` offers open-loop load to nodes or
gateways.
"""

from hbbft_tpu_torch.net.client import ClusterClient, Mempool
from hbbft_tpu_torch.net.cluster import ClusterConfig, LocalCluster
from hbbft_tpu_torch.net.framing import (
    FrameDecoder,
    FrameError,
    Hello,
    PROTOCOL_VERSION,
)
from hbbft_tpu_torch.net.retrieve import (
    RetrievedPayload,
    RetrieveService,
    ShardStore,
)
from hbbft_tpu_torch.net.runtime import NodeRuntime
from hbbft_tpu_torch.net.transport import BackoffPolicy, Transport, TransportStats

__all__ = [
    "BackoffPolicy",
    "ClusterClient",
    "ClusterConfig",
    "FrameDecoder",
    "FrameError",
    "Hello",
    "LocalCluster",
    "Mempool",
    "NodeRuntime",
    "PROTOCOL_VERSION",
    "RetrievedPayload",
    "RetrieveService",
    "ShardStore",
    "Transport",
    "TransportStats",
]
