"""Array-mode protocol rounds: batched RBC, batched ABA, the ACS /
HoneyBadger epoch composed from them, and the multi-epoch drivers over that
epoch (transaction queueing, pipelined epochs, validator-set changes)."""

from hbbft_tpu_torch.parallel.aba import BatchedAba  # noqa: F401
from hbbft_tpu_torch.parallel.acs import (  # noqa: F401
    BatchedAcs,
    BatchedHoneyBadgerEpoch,
)
from hbbft_tpu_torch.parallel.dhb import BatchedDynamicHoneyBadger  # noqa: F401
from hbbft_tpu_torch.parallel.qhb import (  # noqa: F401
    BatchedQueueingDynamicHoneyBadger,
    BatchedQueueingHoneyBadger,
)
from hbbft_tpu_torch.parallel.rbc import BatchedRbc  # noqa: F401
