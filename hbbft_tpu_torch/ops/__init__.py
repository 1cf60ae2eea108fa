"""Tensor ops of the epoch: GF(2^8) bit planes and Reed–Solomon, SHA3 and
Merkle trees, the lazy BLS12-381 field and the G1/G2 ladders.  Each module
mirrors its namesake in the JAX package; ``fp_lazy`` is the counterpart of
``pallas_fp``."""
