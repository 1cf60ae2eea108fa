"""Generate bls381_constants.h from the host BLS12-381 implementation.

Run by the Makefile so the C++ oracle's constants are derived from the same
single source of truth (crypto/bls12_381.py derives everything from the BLS
parameter x) rather than transcribed by hand.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from hbbft_tpu_torch.crypto import bls12_381 as b  # noqa: E402


def limbs(x: int, n: int) -> str:
    out = []
    for _ in range(n):
        out.append(f"0x{x & 0xFFFFFFFFFFFFFFFF:016x}ULL")
        x >>= 64
    assert x == 0
    return "{" + ", ".join(out) + "}"


def fp2(v) -> str:
    return f"{{{limbs(v[0] % b.P, 6)}, {limbs(v[1] % b.P, 6)}}}"


def main():
    g1 = b.g1_affine(b.G1_GEN)
    g2 = b.g2_affine(b.G2_GEN)
    gammas = b._FROB_GAMMA
    print("// generated by gen_bls_constants.py — do not edit")
    print("#pragma once")
    print("#include <cstdint>")
    print(f"static const uint64_t BLS_P[6] = {limbs(b.P, 6)};")
    print(f"static const uint64_t BLS_R[4] = {limbs(b.R, 4)};")
    print(f"static const uint64_t BLS_P_M2[6] = {limbs(b.P - 2, 6)};")
    print(f"static const uint64_t BLS_R_M2[4] = {limbs(b.R - 2, 4)};")
    print(f"static const uint64_t BLS_SQRT_EXP[6] = {limbs((b.P + 1) // 4, 6)};")
    print(f"static const uint64_t BLS_HALF[6] = {limbs(pow(2, -1, b.P), 6)};")
    # |x| does not fit in int64 (it is 64 bits); x is negative for BLS12-381
    print(f"static const uint64_t BLS_X_ABS = {-b.X}ULL;")
    h1 = b.H1
    print(f"static const uint64_t BLS_H1[2] = {limbs(h1, 2)};")
    nh2 = (b.H2.bit_length() + 63) // 64
    print(f"static const int BLS_H2_LIMBS = {nh2};")
    print(f"static const uint64_t BLS_H2[{nh2}] = {limbs(b.H2, nh2)};")
    print(f"static const uint64_t BLS_G1_X[6] = {limbs(g1[0], 6)};")
    print(f"static const uint64_t BLS_G1_Y[6] = {limbs(g1[1], 6)};")
    print(f"static const uint64_t BLS_G2_X[2][6] = {fp2(g2[0])};")
    print(f"static const uint64_t BLS_G2_Y[2][6] = {fp2(g2[1])};")
    print("static const uint64_t BLS_GAMMA[6][2][6] = {")
    for g in gammas:
        print(f"  {fp2(g)},")
    print("};")
    # ψ endomorphism constants (derived + eigenvalue-self-checked in
    # bls12_381._psi_consts) and the GLV/GLS scalar-split parameters — the
    # fast-path multiplications in the oracle (see bls381.cpp: g1_mul_glv /
    # g2_mul_gls / g2_clear_cofactor).
    cx, cy = b._psi_consts()
    print(f"static const uint64_t BLS_PSI_CX[2][6] = {fp2(cx)};")
    print(f"static const uint64_t BLS_PSI_CY[2][6] = {fp2(cy)};")
    print(f"static const uint64_t BLS_GLV_BETA[6] = {limbs(b.glv_beta(), 6)};")
    print(f"static const uint64_t BLS_GLV_LAMBDA[2] = {limbs(b.LAMBDA_G1, 2)};")


if __name__ == "__main__":
    main()
