"""Host threshold cryptography (copies of the JAX package's JAX-free
modules) and the batched device ladders behind TPKE encryption.

- ``bls12_381`` — the curve, pure-Python ints plus the native oracle.
- ``tc`` — the ``threshold_crypto``-shaped key sets and TPKE.
- ``batch`` — the GLV/GLS-split scalar-mul ladders on the device and the
  batched TPKE encrypt/decrypt entry points.
"""
