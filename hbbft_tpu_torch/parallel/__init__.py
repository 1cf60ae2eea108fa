"""Array-mode protocol rounds: batched RBC, batched ABA, and the ACS /
HoneyBadger epoch composed from them."""

from hbbft_tpu_torch.parallel.aba import BatchedAba  # noqa: F401
from hbbft_tpu_torch.parallel.acs import (  # noqa: F401
    BatchedAcs,
    BatchedHoneyBadgerEpoch,
)
from hbbft_tpu_torch.parallel.rbc import BatchedRbc  # noqa: F401
