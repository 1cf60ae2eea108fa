"""Batched SHA3-256: a CUDA kernel and its plain PyTorch version.

Counterpart of ``hbbft_tpu/ops/keccak.py`` (``keccak_f1600`` and
``sha3_256``).  :func:`sha3_256` is the wrapper the Merkle code calls: on a
CUDA tensor it launches ``csrc/keccak.cu`` (two threads per message, one
32-bit half of every lane each, the whole absorb loop in registers) or
raises; on a CPU tensor it runs :func:`sha3_256_plain`.
:func:`sha3_256_host` hashes one ``bytes`` message on the host (object
mode's Merkle trees).

The plain version holds each 64-bit lane in an int64.  PyTorch has no
``>>`` on uint64 on the CPU and ``>>`` on int64 is arithmetic, so every
right shift is masked back to the bits a logical shift would keep.  The
state is ``(25, ...)`` with lane index ``5*y + x`` (the byte-serialization
order), as in the reference.  Round constants and rotation offsets are
derived from the spec (LFSR / triangular numbers).
"""

from __future__ import annotations

import numpy as np
import torch

from hbbft_tpu_torch import _build

RATE_BYTES = 136  # SHA3-256: rate 1088 bits, capacity 512
DIGEST_BYTES = 32


def _rc_bit(t: int) -> int:
    if t % 255 == 0:
        return 1
    R = 1
    for _ in range(1, t % 255 + 1):
        R <<= 1
        if R & 0x100:
            R ^= 0x171
    return R & 1


def _round_constants():
    rcs = []
    for i in range(24):
        rc = 0
        for j in range(7):
            rc |= _rc_bit(7 * i + j) << ((1 << j) - 1)
        rcs.append(rc)
    return rcs


ROUND_CONSTANTS = _round_constants()


def _rho_pi_tables():
    """Per-target-lane source index and rotation of the fused ρ∘π step:
    ``out[tgt] = rotl(state[src[tgt]], rot[tgt])``."""
    r = np.zeros((5, 5), dtype=np.int64)  # r[x, y]
    x, y = 1, 0
    for t in range(24):
        r[x, y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    src = np.zeros(25, dtype=np.int64)
    rot = np.zeros(25, dtype=np.int64)
    for yt in range(5):
        for xt in range(5):
            tgt = 5 * yt + xt
            sx = (xt + 3 * yt) % 5
            sy = xt
            src[tgt] = 5 * sy + sx
            rot[tgt] = r[sx, sy]
    return src, rot


_PI_SRC, _PI_ROT = _rho_pi_tables()


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return v - (1 << 64) if v >= 1 << 63 else v


_CONSTS: dict = {}


def _consts(device):
    hit = _CONSTS.get(device)
    if hit is None:
        rot = torch.from_numpy(_PI_ROT)
        hit = _CONSTS[device] = {
            "rc": [torch.tensor(_signed(c), dtype=torch.int64, device=device)
                   for c in ROUND_CONSTANTS],
            "src": torch.from_numpy(_PI_SRC).to(device),
            "rot": rot.to(device),
            # right-shift amounts capped at 63 (rot 0 masks to nothing)
            "rsh": torch.clamp(64 - rot, max=63).to(device),
            "rmask": torch.tensor(
                [(1 << int(r)) - 1 for r in _PI_ROT], dtype=torch.int64,
                device=device,
            ),
            "bytesh": torch.arange(0, 64, 8, dtype=torch.int64, device=device),
        }
    return hit


def _rotl(x, s: torch.Tensor, rsh: torch.Tensor, rmask: torch.Tensor):
    """Rotate int64 lanes left by ``s`` (broadcast), with the logical right
    shift emulated as an arithmetic shift masked to its low ``s`` bits."""
    return (x << s) | ((x >> rsh) & rmask)


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """One keccak-f[1600] permutation of int64 lanes (25, ...)."""
    k = _consts(state.device)
    ext = [1] * (state.dim() - 1)
    rot = k["rot"].reshape(25, *ext)
    rsh = k["rsh"].reshape(25, *ext)
    rmask = k["rmask"].reshape(25, *ext)
    one = torch.ones((), dtype=torch.int64, device=state.device)
    s63 = torch.full((), 63, dtype=torch.int64, device=state.device)
    st = state
    for rc in k["rc"]:
        T = st.reshape(5, 5, *st.shape[1:])  # [y, x, ...]
        C = T[0] ^ T[1] ^ T[2] ^ T[3] ^ T[4]  # [x, ...]
        D = torch.roll(C, 1, 0) ^ _rotl(torch.roll(C, -1, 0), one, s63, one)
        st = (T ^ D[None]).reshape(25, *st.shape[1:])
        st = _rotl(st[k["src"]], rot, rsh, rmask)
        T = st.reshape(5, 5, *st.shape[1:])
        T = T ^ (~torch.roll(T, -1, 1) & torch.roll(T, -2, 1))
        st = T.reshape(25, *st.shape[1:])
        st[0] ^= rc
    return st


def sha3_256_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch SHA3-256: uint8 (..., L) → (..., 32).

    Pads per FIPS-202 (domain 0x06, final bit 0x80), absorbs at rate 136,
    squeezes 32 bytes; bit-exact with ``hashlib.sha3_256``."""
    dev = data.device
    L = data.shape[-1]
    batch = data.shape[:-1]
    nblocks = L // RATE_BYTES + 1
    m = torch.zeros((*batch, nblocks * RATE_BYTES), dtype=torch.int64, device=dev)
    m[..., :L] = data.to(torch.int64)
    m[..., L] ^= 0x06
    m[..., -1] ^= 0x80
    sh = _consts(dev)["bytesh"]
    # (…, nblocks, 17, 8) bytes → (…, nblocks, 17) lanes, little-endian
    words = m.reshape(*batch, nblocks, RATE_BYTES // 8, 8) << sh
    lanes = words[..., 0]
    for j in range(1, 8):
        lanes = lanes | words[..., j]
    lanes = lanes.movedim(-1, 0).movedim(-1, 0)  # (nblocks, 17, ...)
    st = torch.zeros((25, *batch), dtype=torch.int64, device=dev)
    for i in range(nblocks):
        st[: RATE_BYTES // 8] ^= lanes[i]
        st = keccak_f1600(st)
    out = (st[:4].movedim(0, -1)[..., None] >> sh) & 0xFF  # (…, 4, 8)
    return out.reshape(*batch, DIGEST_BYTES).to(torch.uint8)


def sha3_256(data: torch.Tensor) -> torch.Tensor:
    """Batched SHA3-256 of equal-length messages: uint8 (..., L) → (..., 32).

    A CUDA tensor goes through the hand-written kernel (``csrc/keccak.cu``)
    and a CPU tensor through :func:`sha3_256_plain`."""
    if not data.is_cuda:
        return sha3_256_plain(data)
    if data.dtype != torch.uint8:
        raise TypeError(f"sha3_256 takes uint8, got {data.dtype}")
    batch = data.shape[:-1]
    L = data.shape[-1]
    msgs = data.reshape(batch.numel(), L).contiguous()
    out = torch.empty((msgs.shape[0], DIGEST_BYTES), dtype=torch.uint8,
                      device=data.device)
    if msgs.shape[0]:
        lib = _build.lib("sha3_256")
        rc = lib.hb_sha3_256(
            msgs.data_ptr(), msgs.shape[0], L, out.data_ptr(),
            _build.stream_ptr(data),
        )
        _build.check("sha3_256", rc)
        _build.count("sha3_256")
    return out.reshape(*batch, DIGEST_BYTES)


def sha3_256_host(data: bytes) -> bytes:
    """SHA3-256 of one host message: Python's built-in FIPS-202 hash (the
    object-mode Merkle tree's hash, counterpart of the reference's
    ``sha3_256_host``)."""
    import hashlib

    return hashlib.sha3_256(data).digest()
