"""C++ CPU oracles, loaded via ctypes (no pybind11 in this environment).

The reference links native Rust crates (``reed-solomon-erasure``,
``tiny-keccak``) for its hot math; our TPU kernels are the production path and
these C++ oracles are the bit-exactness ground truth (SURVEY §2.2).  The
library is compiled on first use with ``make`` (g++); if compilation is
impossible the loader raises and oracle tests are skipped.
"""

from hbbft_tpu_torch.native.oracle import NativeOracle, get_oracle

__all__ = ["NativeOracle", "get_oracle"]
