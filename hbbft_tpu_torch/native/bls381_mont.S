# 6-limb (384-bit) Montgomery multiplication for x86-64 with BMI2+ADX.
#
# void hbbft_mont_mul_384(uint64_t* out, const uint64_t* a,
#                         const uint64_t* b, const uint64_t* p, uint64_t n0)
#
# CIOS with the dual carry chain (mulx feeds adcx for the low halves and
# adox for the high halves), the standard lowering for Montgomery ladders on
# Broadwell+.  ~4x the throughput of the __int128 C version that remains the
# portable fallback (bls381.cpp Mod<6>::mul) and its differential-test
# oracle: dispatch happens only when the build host defines __ADX__/__BMI2__
# (-march=native), so the instructions always match the machine.
#
# Register plan (SysV args rdi=out rsi=a rdx=b rcx=p r8=n0):
#   t[0..6]  r8..r14      accumulator (t < 2p invariant per iteration)
#   rbp = b, rbx = p, rsi = a, n0 in the red zone
#   rax/rcx  mulx lo/hi temps, rdx the mulx multiplicand
#   epilogue borrows rax,rcx,rdx,rbp,rsi,r15 for the conditional subtract

    .text
    .intel_syntax noprefix
    .globl hbbft_mont_mul_384
    .type  hbbft_mont_mul_384, @function

# one CIOS iteration for a[\off]: t += a_i*b; m = t0*n0; t += m*p; t >>= 64
.macro CIOS_ITER off
    mov     rdx, [rsi + \off]
    xor     ecx, ecx                  # clear CF and OF
    mulx    rcx, rax, [rbp]
    adcx    r8, rax
    adox    r9, rcx
    mulx    rcx, rax, [rbp + 8]
    adcx    r9, rax
    adox    r10, rcx
    mulx    rcx, rax, [rbp + 16]
    adcx    r10, rax
    adox    r11, rcx
    mulx    rcx, rax, [rbp + 24]
    adcx    r11, rax
    adox    r12, rcx
    mulx    rcx, rax, [rbp + 32]
    adcx    r12, rax
    adox    r13, rcx
    mulx    rcx, rax, [rbp + 40]
    adcx    r13, rax
    adox    r14, rcx
    mov     eax, 0
    adcx    r14, rax                  # fold the CF tail (OF tail is 0)

    mov     rdx, [rsp - 8]            # n0
    imul    rdx, r8                   # m = t0 * n0 (low 64 bits)
    xor     ecx, ecx
    mulx    rcx, rax, [rbx]
    adcx    r8, rax                   # t0 + lo(m*p0) == 0 mod 2^64
    adox    r9, rcx
    mulx    rcx, rax, [rbx + 8]
    adcx    r9, rax
    adox    r10, rcx
    mulx    rcx, rax, [rbx + 16]
    adcx    r10, rax
    adox    r11, rcx
    mulx    rcx, rax, [rbx + 24]
    adcx    r11, rax
    adox    r12, rcx
    mulx    rcx, rax, [rbx + 32]
    adcx    r12, rax
    adox    r13, rcx
    mulx    rcx, rax, [rbx + 40]
    adcx    r13, rax
    adox    r14, rcx
    mov     eax, 0
    adcx    r14, rax
    mov     r8, r9                    # t >>= 64 (t0 is zero by REDC)
    mov     r9, r10
    mov     r10, r11
    mov     r11, r12
    mov     r12, r13
    mov     r13, r14
    xor     r14d, r14d
.endm

hbbft_mont_mul_384:
    push    rbx
    push    rbp
    push    r12
    push    r13
    push    r14
    push    r15
    mov     [rsp - 8], r8             # n0 (leaf red zone)
    mov     rbp, rdx                  # b
    mov     rbx, rcx                  # p
    xor     r8d, r8d                  # t = 0
    xor     r9d, r9d
    xor     r10d, r10d
    xor     r11d, r11d
    xor     r12d, r12d
    xor     r13d, r13d
    xor     r14d, r14d

    CIOS_ITER 0
    CIOS_ITER 8
    CIOS_ITER 16
    CIOS_ITER 24
    CIOS_ITER 32
    CIOS_ITER 40

    # conditional subtract: out = t >= p ? t - p : t   (t < 2p, 6 limbs)
    mov     rax, r8
    mov     rcx, r9
    mov     rdx, r10
    mov     rbp, r11
    mov     rsi, r12
    mov     r15, r13
    sub     rax, [rbx]
    sbb     rcx, [rbx + 8]
    sbb     rdx, [rbx + 16]
    sbb     rbp, [rbx + 24]
    sbb     rsi, [rbx + 32]
    sbb     r15, [rbx + 40]
    cmovnc  r8, rax                   # no borrow -> t >= p -> take t - p
    cmovnc  r9, rcx
    cmovnc  r10, rdx
    cmovnc  r11, rbp
    cmovnc  r12, rsi
    cmovnc  r13, r15
    mov     [rdi], r8
    mov     [rdi + 8], r9
    mov     [rdi + 16], r10
    mov     [rdi + 24], r11
    mov     [rdi + 32], r12
    mov     [rdi + 40], r13
    pop     r15
    pop     r14
    pop     r13
    pop     r12
    pop     rbp
    pop     rbx
    ret
    .size hbbft_mont_mul_384, .-hbbft_mont_mul_384
    .section .note.GNU-stack,"",@progbits
