"""PyTorch/CUDA port of the array-mode HoneyBadgerBFT epoch.

The JAX package ``hbbft_tpu`` is the reference; this package computes the
same epoch (TPKE encrypt → batched RBC → batched ABA → threshold decrypt)
with plain PyTorch tensors and CUDA kernels written for Hopper
(``csrc/``: the bitwise and windowed whole-ladder kernels, the lazy field
multiply, SHA3, the GF(2) bit-plane product of the erasure coders), and the threshold-crypto batch calls around it
(``crypto/batch.py``).  Module names mirror the reference's (``ops/``,
``parallel/``, ``crypto/``).

Entry points take ``device=`` and default to ``"cuda"``: without a card
they raise rather than run on the CPU.  Pass ``device="cpu"`` to run the
plain PyTorch versions of the kernels (the CPU tests do).
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    card is visible — nothing here falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} asks for CUDA but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
