#!/usr/bin/env python3
"""Drive the PyTorch port of the HoneyBadger epoch and its threshold crypto
on one NVIDIA card.

    python3 chip_smoke.py            # build, kernel checks, epochs, drivers, mesh, coin256, dkg256
    python3 chip_smoke.py --phases kernel_field,kernel_ladder_window   # those (and build)
    python3 chip_smoke.py --phases lint   # the port's static analysis (and build)
    python3 chip_smoke.py --phases qhb64,dhb --dhb-n 16   # the drivers; dhb at N = 16
    python3 chip_smoke.py --phases epoch4096,sustained4096   # BASELINE config 5
    python3 chip_smoke.py --phases kernel_bitplane,epoch16384   # the GF(2) kernel; N = 16384
    python3 chip_smoke.py --phases kernel_ladder_mxu   # the 8-bit field's ladder kernel, its route
    python3 chip_smoke.py --phases objsim   # object mode: the simulation CLI
    python3 chip_smoke.py --phases vidsim   # the node stack on VirtualNet at N = 22
    python3 chip_smoke.py --phases netsim   # the node runtime over localhost TCP at N = 22
    python3 chip_smoke.py --phases edge22   # 22 node processes behind a gateway, the tools
    python3 chip_smoke.py --phases edge22 --keep-journals DIR   # and keep a prefix of the journals

Phases, one JSON line each; any failure exits non-zero:

1. ``build``: nvcc builds the six kernels from ``hbbft_tpu_torch/csrc``
   for sm_90a (one nvcc per source, started together) while the native BLS
   oracle builds beside them.
2. ``lint``: the port's static analysis, ``python -m hbbft_tpu_torch.lint
   --json``, over the tree as shipped (the package and this file): no
   finding and no stale baseline entry; its counts and seconds.  No kernel.
3. ``kernel_field``: the lazy field at K = 1, 2 and 4 elements a warp
   (``fp_lazy.cuh``, through the probe kernel of ``ladder_window.cu``, on
   no path) digit-exact against the plain field at 37 and 4 096 rows; a
   warp's latency of a chained MUL, ADD and SUB at each K; the SASS
   instructions of each (``cuobjdump -sass``).
4. ``kernel_fp_mul_lazy``: Kernel 1 (the warp-per-row lazy multiply)
   against its plain PyTorch version on the card, digit-exact, at 1, 63,
   128, 256, 384 and 8192 rows.
5. ``kernel_sha3``: Kernel 2 against its plain version and hashlib,
   byte-exact, over message lengths 0 … 64 KiB and batches up to 4097,
   including the epochs' own shapes (at N = 64 4096 Merkle leaves of one
   shard each and 2048 interior pairs of 64 bytes; the leaves of one
   64-proposer chunk: 65 536 at N = 1024, 262 144 of 2 bytes at N = 4096),
   timed there by CUDA events and by the profiler's device time per launch.
6. ``kernel_bitplane``: first a ``bitplane_probe`` line, the card's 1-bit
   tensor rates (``mma.sync`` m16n8k256 and ``wgmma`` m64n128k256, .b1
   .and.popc, on every SM: bit-products a second, against the LOP3 pipe's
   and the int8 peak's multiply-adds); then the GF(2) bit-plane product
   over packed bits (``csrc/bitplane.cu``) against its plain version (the
   operands unpacked, a float32 product) on the card, bit-exact, at the
   shapes its paths give it: the N = 64 epoch's GF(2^8) encode (187 136
   byte rows, 176 bits, 336 columns), the mesh round's masked decode (1 408
   decode matrices of 176 x 176 bits over 2 924 rows each), one
   64-proposer chunk's GF(2^16) encode at N = 1024 (6 080 rows, 5 472 bits,
   10 912 columns) and at N = 4096 (64 rows, 21 856 bits, 43 680 columns);
   each timed by CUDA events beside three bounds (bytes against the
   measured 1-bit rate, the int8 peak, and one LOP3 a row, column and
   word), the plain version, the library calls on the unpacked operands
   (float32 ``torch.matmul`` and, for one 2-D product, ``torch._int_mm`` of
   the int8 bits), and the launch plan (route, tiles) it took.
7. ``kernel_ladder``: the bitwise whole-ladder kernel against the plain
   stepwise ladder on the card (plain multiply, no kernel), digit-exact and
   inf-exact, at the N = 64 epoch's encrypt shapes (G1 256 rows, G2 128
   rows; 132 bits) with edge rows (a zero scalar, all-ones bits, base_inf
   padding), and against the native oracle's affine points on five rows
   of each shape; each shape timed.  No path runs this kernel now (the
   windowed one was faster at every size measured); it stays held against
   its plain version.
8. ``kernel_ladder_window``: the 4-bit windowed kernel, the one every path
   runs, against its plain version, digit- and inf-exact, at G1 256 / 37 /
   4 096 / 16 384 / 16 rows (N = 64 and coin256, ragged, N = 1024 and
   4096, dkg256's forced device route, objsim's share-set fold) and G2 128
   / 256 / 37 / 2 048 / 8 192 rows (the last one N = 4096 encrypt in a
   single chunk), with the same
   edge rows, three rows each against the native oracle; timed with its
   bound, the K it runs at, its registers, spilled bytes, blocks an SM and
   the SASS instructions of a lazy operation at that K.
9. ``ladder_crossover``: both ladder kernels at 128 … 65 536 rows, G1 and
   G2, ms of one launch each by CUDA events, the windowed one also at each
   K beside the K it picks (every K's result equal): why every dispatch
   runs the windowed kernel, and at which K.
10. ``kernel_ladder_mxu``: the windowed ladder over the reference's 8-bit
   field (``csrc/ladder_mxu.cu``: the windowed kernel's design, several
   warps a row on the shared step tables and K rows a block, each product's
   digit convolution and the K rows' shared fold as ``mma.sync`` f16
   products on the tensor cores) against its plain version, digit- and
   inf-exact, at G1 16 / 256 and G2 128 / 256 rows (a share-set fold, the
   N = 64 encrypt, coin256), with the edge rows, three rows each against
   the native oracle, and at ragged rows and short scalars (G1 37 rows of 8
   bits, G2 5 of 20); each timed by CUDA events and the profiler against
   its bound, beside ``ladder_window`` at the same rows, with the K it runs
   at, its warps, registers, spilled bytes, shared memory and blocks an SM.
   A sweep against ``ladder_window`` at G1 and G2, 16 … 8 192 rows, every
   row held exact against the plain version and the kernel timed at each K
   (every K's result equal): where the 8-bit field crosses the 13-bit one,
   and the K thresholds.  Then, under ``HBBFT_FIELD_BACKEND=mxu`` (restored after),
   one N = 64 epoch (ciphertexts equal to the native oracle's, every
   contribution back) and one coin256 verify (True; False with a forged
   share), every ladder a ``ladder_mxu`` launch and none a ``ladder_window``
   one.  The default route (``MXU_MAX_BATCH`` None) never launches it.
11. ``epoch``: HoneyBadger epochs at N = 64 (f = 21, 64 000-byte
   contributions) with the TPKE encrypt ladders on the card: a warm run
   whose ciphertexts are held against the native oracle's, then 5 timed
   runs, each with every kernel's launch counter reset just before it and
   read just after (2 windowed ladder launches, SHA3 21, 3 bit-plane
   products: the encode, the batched decode, the re-encode; Kernel 1 none).
12. ``profile``: the device's busy share (kernel time from torch.profiler
   over wall time) and kernel launches, over the whole encrypt phase and
   over ACS + decrypt.
13. ``qhb64``: ``BatchedQueueingHoneyBadger`` at N = 64, 256 transactions
   of 250 B a node an epoch (65 028-byte contributions) from a queue of
   1 024 of its own, device encrypt route: 8 ``run_epochs_pipelined``
   epochs then ``run_to_empty``, and a second one's 8 sequential
   ``run_epoch``s; every transaction committed once, launch totals of 2
   windowed ladders and 21 SHA3 batches an epoch, the first pipelined
   epoch's ciphertexts equal to the native oracle's.
14. ``rbc_large``: the N > 256 scale path, ``BatchedRbc(1024, 341)`` over
   1 024 proposers with the GF(2^16) coder: full delivery (every verdict
   and value; four proposers' shards equal to the host ``encode_np`` and
   their roots to hashlib's), data shards altered after the commit (the
   straggler decode and the re-check stage), a framing fault, each with
   one bit-plane launch a proposer chunk and stage (16, 32, 16); and the
   device time of the GF(2^16) encode of one 64-proposer chunk.
15. ``epoch1024``: HoneyBadger epochs at N = 1024 (f = 341, the same
    contributions) through the scale path: keygen, a warm run held against
    the native oracle's ciphertexts, 1 timed run with launch counts as
    derived from the code (ladder 2, SHA3 16 chunks × 11 Merkle levels,
    bit-plane 16, one encode a chunk; Kernel 1 none), and one profiled run
    for the device's idle share and the device time of the bit-plane
    kernel, SHA3 and the ladders.
16. ``epoch4096``: BASELINE config 5, HoneyBadger epochs at N = 4096 (f =
    1365, one 64-byte transaction a node, ``compact=True``, as bench.py's
    ``bench_hb_epoch4096``): keygen, the GF(2^16) coder's build (closed-form
    matrix on the host, packed bit matrix on the card) with its seconds and
    device memory, then ``epoch1024``'s gates and times (warm run against
    the native oracle, 1 timed run, launches as ``large_epoch_launches``
    derives them: 4 encrypt chunks of 1 024 proposers, 2 ladders each; SHA3
    64 chunks × 13 Merkle levels; bit-plane 64; Kernel 1 none; a profiled
    run).
17. ``sustained4096``: bench.py's ``sustained4096`` session on the same
    network: the encrypt route calibrated (native against device, one warm
    encrypt phase each, the faster kept), then SUSTAINED_EPOCHS epochs with
    epoch e+1's encrypt on a worker thread while epoch e runs; every batch
    equal to the contributions, launches as derived; epochs/s and drift.
18. ``epoch16384``: bench.py's ``bench_hb_epoch16384`` (N = 16384, f = 5461,
    32 bytes a node, ``compact=True``, the keys from ``Random(23)``): the
    keygen timed, the coder's build (the closed-form (16384, 5462) matrix
    on the host, its 1.9 GB packed bit matrix on the card: the float32 one
    would be 61 GB) with its seconds and device bytes, the bit-plane kernel
    at one chunk (64 rows, 87 392 bits, 174 752 columns) timed beside its
    bounds and held bit-exact against its plain version, the plain version
    and ``torch._int_mm`` of the int8 bits timed in slices of 16 384
    columns and summed, then ``epoch4096``'s gates on one timed epoch
    (launches: 16 encrypt chunks, 2 ladders each; SHA3 256 chunks × 15
    Merkle levels; bit-plane 256; no profiled epoch) and three proposers'
    shards from stage A against the host ``encode_np``; peak device memory.
19. ``mesh``: the device mesh (``parallel/mesh.py``) under an NCCL world
    of one rank on cuda:0, its process group destroyed at the end: the N =
    64 epoch sharded over a 1-D and a 1 × 1 ``("dcn", "ici")`` mesh held
    equal to the unsharded epoch on the same inputs (ciphertext bytes,
    batch, ``accepted``; launches of the sharded run), the N = 1024 round
    through ``make_sharded_rbc_large_run`` equal to the unsharded one
    (clean, and with data shards altered), coin256 through
    ``make_sharded_coin_verify`` (True; False with a forged share), the
    ``STATS`` deltas, sharded and unsharded seconds; then
    ``graft_entry.dryrun_multichip(1, quick=True)``, its JSON line first.
    World size 1 moves nothing over a collective: no speed claim.
20. ``coin256``: the common coin at N = 256, f = 85 (BASELINE config 3):
    ``batch_verify_sig_shares`` over 256 signature shares (True; False with
    one share over another message; median of 3, its split into host
    dispatch, ladder wait, fetch + host fold and pairing check; the
    ladders' device ms and launches), the MSMs against the host's sums, and
    ``batch_verify_dec_shares`` over 256 decryption shares (True; False
    with one tampered).
21. ``dkg256``: ``commitment_row(com, 3)`` at t = 85 on the production and
    the forced device route against ``com.row(3)``, ``commitment_eval`` and
    ``bivar_commitment`` on the forced route against their host values,
    and the sweeps ``crypto/batch.py``'s routing thresholds are set from,
    host against device, every route's result equal: ``bivar_commitment``
    at t = 0 … 24, ``commitment_row``/``_eval`` at t = 2 … 85 (the host
    route was faster at every point up to t = 181), the RLC fold and the
    share generation by rows, TPKE encrypt and decrypt of 64 000-byte
    messages at N = 64, and the encrypt without the native oracle.
22. ``dhb``: ``BatchedQueueingDynamicHoneyBadger`` at N = 8 (``--dhb-n``):
    plain epochs with queued transactions, a vote adding one validator,
    epochs until the change completes, 2 epochs of the new era; the new
    key set's threshold decrypt, no transaction committed twice, and the
    driver pickled after the rotation (no CUDA tensor in it) restored with
    ``device="cpu"`` to the same next batch.  The DKG is host work of
    order N³, which bounds N here, not the card.
23. ``objsim``: object mode (QHB over DHB over ``VirtualNet``) through the
    simulation CLI on the card: (a) N = 10 at the defaults of upstream
    ``examples/simulation.rs`` (1 000 transactions of 10 B, batches of 100,
    the JAX CLI's cost model) under the native and the device erasure
    backend — every node's ledger equal, each transaction committed once,
    no fault, and both runs equal in ledgers, message counts, wire bytes
    and virtual time; (b) N = 22, f = 7 (22 transactions, one a node, so one
    epoch; batch 220):
    the same ledger gates, one ``ladder_window`` launch for each share-set
    fold of ≥ 8 rows, one bit-plane launch a product of the device erasure
    backend and none else, the first 32 folds held against the host loop;
    wall seconds, cranks, messages and messages/s.
24. ``vidsim``: the node stack without the network at N = 22, f = 7, on
    ``VirtualNet`` under the device erasure backend, every node built as
    the reference's ``net/cluster.py`` ``build_algo`` builds it with
    encryption always, 64 transactions of 250 B a node, node 21's links
    capped (``bandwidth-asym``): (a) ``SenderQueue(VidQueueingHoneyBadger
    (DHB))`` to quiescence, node 0 snapshotted after its first committed
    epoch (byte-identical when taken twice and after a restore, no CUDA
    tensor), then every commitment retrieved from k = 8 shards by the
    nodes' ``RetrieveService``s — the same (proposer, certificate) list on
    every node, every payload equal to its proposer's, every transaction
    committed once, no fault; (b) ``SenderQueue(QueueingHoneyBadger(DHB))``
    on the same network with the same gates but retrieval.  Both: one
    ``ladder_window`` launch a share-set fold, one bit-plane launch an
    erasure product and no other launch, every erasure product on the
    device; crank-loop seconds, cranks, messages,
    virtual time, the shaper's counters, VID's counters and a host split.
25. ``netsim``: the node runtime over real sockets at N = 22, f = 7: an
    in-process ``LocalCluster`` (``ClusterConfig(device="cuda")``, 22
    ``NodeRuntime``s, each with its own pump thread, over localhost TCP on
    ephemeral ports), ``encrypt=True``, batches of 64, the flight recorder
    on, the device erasure backend; 250-byte transactions, each distinct,
    submitted through a ``ClusterClient`` connected to its own node.  (a)
    the classic stack at pipeline depth 2, 64 transactions a node; (b) the
    VID stack, 64 a node, whose payloads the runtimes' ``RetrieveService``s
    fetch.  Gates: every transaction committed exactly once on every node,
    one ledger-digest chain on all 22 as long as the epochs run, every
    node's ``/status`` with 0 decode failures and 21 peers connected,
    flight records written and none failed, two device folds and no host
    fold for each share-set job the pumps hand ``verify_dec_share_sets``
    (on the cluster's device), ``ladder_window`` launches = 2 × those jobs,
    one bit-plane launch an erasure product and no other launch, every
    erasure product on the device, in (b) 0
    retrieval mismatches and failures, and ``LocalCluster.stop()`` within
    10 s.  Wall time to the last commit, tx/s, client latency p50/p99, the
    pumps' segment seconds, merged calls and jobs a call, ms a fold,
    erasure bytes/s.
26. ``edge22``: the deployment ``python -m hbbft_tpu_torch.cluster_launch``
    starts, on the card. (a) 22 node **processes** (``ClusterConfig(n=22,
    seed=0, device="cuda", encrypt=True, batch_size=64, pipeline_depth=2)``,
    the flight recorder on, the device erasure backend, ``netsim``'s 5 s
    pings and 30 s dead-peer window), each under this file's ``--edge-node``
    child mode (``netsim``'s spies; its launches, seams and loop stalls
    written to a file when it stops); one gateway process (``python -m
    hbbft_tpu_torch.net.gateway``) with 2 authenticated node links; the
    open-loop generator (``net/loadgen.py``) through the gateway only: 16
    clients, waves of 16 distinct 250-byte transactions, 64 tx/s offered
    for 15 s; then at most 120 s until every node's ``/status`` shows every
    admitted transaction and one chain head. (b) Two watchtower CLIs
    (``obs.watch``), so that the poll never waits behind the tail: one
    polls the 22 nodes and the gateway once a second until the cluster
    settles, one tails the 22 journals through the streaming auditor until
    it has fed every record (at most 240 s after the nodes stop); one
    ``obs.top --json`` snapshot. (c) ``obs.audit`` and ``obs.critpath`` on
    the 22 journals, beside the tail's catching up. (d) The campaign
    on the card: ``smoke_grid()``, the equivocator under loss, one
    ``garbage-stream`` and one ``spoof-nokey`` socket cell. Gates: every
    transaction the gateway admitted journaled as committed exactly once on
    each node; the audit ``clean`` (exit 0) with 22 chains and one head;
    critpath's components summing to each total (to 1e-6 s); the poll
    finishing a tick at least every 2 s under load with every target up,
    the tail feeding every journal record and finishing the tick that fed
    the last with the verdict ``clean``, and zero incidents from either;
    22 node rows and a gateway row; 0 decode
    failures and 21 peers on every ``/status``; summed over the processes,
    ``ladder_window`` launches = 2 × merged share-set jobs, bit-plane
    launches = erasure products, no host fold, no other launch (and in this
    process's campaign cells one bit-plane launch a device erasure product,
    no other); every erasure product on the card; every node process
    with ``torch.cuda.is_available()`` and its stack on ``cuda``; smoke
    cells clean and committing, the equivocator triaged to node 3 and its
    first epoch, the socket cells clean and committing with the flood
    attributed to the claimed identity and every spoofed hello refused and
    attributed to the attacker's endpoint.
27. ``kernels``: every kernel with its launches, errors and times; then the
    whole run's seconds.

Bounds are the larger of bytes over HBM's rate and int32 instructions over
the card's int32 pipes (the ``peak`` line: an ALU and an FMA pipe of 64
lanes a clock per SM each, 128 dispatched a clock per SM, at the maximum SM
clock that nvidia-smi reports).  Then the card's name and power
limit as nvidia-smi prints them, and last
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import hashlib
import json
import os
import random
import re
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# The card's ceilings.  Bytes: HBM at 3.35 TB/s (H100 SXM data sheet).
# Operations: the kernels do 32-bit integer work, which Hopper issues on two
# pipes of 64 lanes a clock per SM (16 in each of the 4 sub-partitions):
# the ALU pipe (logic, shifts, selects, compares, LEA) and the FMA pipe
# (IMAD, and the adds, moves and left shifts that the compiler issues there
# as IMAD.IADD / IMAD.MOV / IMAD.SHL); each sub-partition dispatches one
# warp instruction a clock, 128 lanes a clock per SM in all (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0; Nsight Compute's pipe descriptions).  The least time of a mix is the
# largest of its ALU-only work over 64, its multiply-adds over 64 and all
# of it over 128, in clocks per SM, at the card's maximum SM clock read from
# nvidia-smi.  Work is counted as the fewest instructions the function
# needs, as (ALU only, multiply-add, either pipe): a multiply-add, a
# three-input logic op (LOP3), a three-input add and a funnel shift are one
# instruction each.
PEAK_BYTES_PER_S = 3.35e12
# int8 tensor-core peak, dense (H100 SXM data sheet); no 1-bit rate is
# published for Hopper, so kernel_bitplane measures one (bitplane_probe_rates)
INT8_PEAK_OPS_PER_S = 1.979e15
PIPE_PER_CLOCK_PER_SM = 64
DISPATCH_PER_CLOCK_PER_SM = 128

# int32 instructions of the lazy field, per row (the plain algorithm's
# passes, which the kernels compute).  A rough carry pass is 2 ALU
# instructions a digit: the mask (LOP3) and the shift-and-add (LEA.HI), as
# the ladder kernel's SASS has them.  The squeeze: 3 passes over 31 digits,
# then 4 rounds of 30 multiply-adds and 3 passes.  A product: the 30×30
# convolution (900 multiply-adds), 3 passes over 61 digits, the fold of 31
# digits against 30-limb rows (930 multiply-adds), the squeeze.  The add: 1
# a digit and the squeeze; the sub: a − b + constant, one three-input add a
# digit, and the squeeze; a select: 1 a digit (SEL, or a predicated
# IMAD.MOV).
CARRY_OPS = 2
SQUEEZE_OPS = (3 * 31 * CARRY_OPS + 4 * 3 * 31 * CARRY_OPS, 4 * 30, 0)
FP_KIND_OPS = {
    "MUL": (3 * 61 * CARRY_OPS + SQUEEZE_OPS[0], 900 + 930 + SQUEEZE_OPS[1], 0),
    "ADD": (SQUEEZE_OPS[0], SQUEEZE_OPS[1], 30),
    "SUB": (SQUEEZE_OPS[0], SQUEEZE_OPS[1], 30),
    "SEL": (0, 0, 30),
}
FP_BYTES_PER_ROW = 3 * 30 * 4
LADDER_BITS = 132  # the GLV/GLS half-scalar ladders of crypto/batch.py
# int32 instructions per 136-byte SHA3 block, all ALU: 24 rounds, each on
# both 32-bit halves of the 25 lanes: θ's column parities (2 LOP3 a column),
# the rot-1 of 5 parities (a funnel shift each), θ's XOR of two parities
# into every lane (a LOP3 each), ρ (24 funnel shifts; π only renames), χ (a
# LOP3 a lane) and ι (one XOR); then the 17-lane absorb, one XOR a half.
SHA3_OPS_PER_BLOCK = (24 * 2 * (10 + 5 + 25 + 24 + 25 + 1) + 17 * 2, 0, 0)

N_NODES = 64
CONTRIB_BYTES = 64000
CIPHERTEXT_BYTES = 294 + CONTRIB_BYTES  # the TPKE header, then the body
TIMED_EPOCHS = 5
# SHA3 launches in one N = 64 epoch: 21 batches (Merkle leaf level + 6
# interior levels, for the commit, the proof checks and the root check)
EPOCH_SHA3_LAUNCHES = 21
# bit-plane launches in one N = 64 epoch (full delivery): the encode, the
# batched survivor decode, the re-encode
EPOCH_BITPLANE_LAUNCHES = 3
LADDER_KERNELS = ("ladder_lazy", "ladder_window", "ladder_mxu")
# the scale path's configuration: N = 1024, f = 341 (k = 342 data shards of
# 190 B for the same 64 000-byte contributions), through the GF(2^16) coder
N_LARGE = 1024
F_LARGE = 341
TIMED_EPOCHS_LARGE = 1
# BASELINE config 5 (bench.py's ``bench_hb_epoch4096`` and
# ``sustained4096``): N = 4096, f = 1365 (k = 1366), one 64-byte transaction
# a node, ciphertexts of 358 B, shards of 2 B; the sustained session's
# epochs cut from BASELINE's 100 to fit this script's time limit
N_4096 = 4096
F_4096 = 1365
CONTRIB_BYTES_4096 = 64
TIMED_EPOCHS_4096 = 1
SUSTAINED_EPOCHS = 4
# bench.py's ``bench_hb_epoch16384``: N = 16384, f = 5461 (k = 5462), one
# 32-byte contribution a node, ciphertexts of 326 B, shards of 2 B
N_16384 = 16384
F_16384 = 5461
CONTRIB_BYTES_16384 = 32


def merkle_root_levels(n: int) -> int:
    """Hash levels of ``merkle_root`` over n leaves: the leaf level and one
    per halving (an odd node is carried up)."""
    levels, w = 1, n
    while w > 1:
        w = (w + 1) // 2
        levels += 1
    return levels


def ladder_launches(n: int, kernel: str = "ladder_window") -> dict:
    """Launches of the ladder kernels for ``n`` windowed ladders: every
    dispatch runs the windowed kernel of its field (``ladder_window``, the
    13-bit default; ``ladder_mxu`` under ``HBBFT_FIELD_BACKEND=mxu``), none
    the bitwise one."""
    return {**{k: 0 for k in LADDER_KERNELS}, kernel: n}


def encrypt_ladder_launches(n: int) -> dict:
    """Ladder launches of one device-route TPKE encrypt of n proposers:
    per encrypt chunk (``DEVICE_ENCRYPT_CHUNK`` proposers) one G1 and one
    G2 ladder."""
    from hbbft_tpu_torch.crypto.batch import DEVICE_ENCRYPT_CHUNK

    return ladder_launches(2 * -(-n // DEVICE_ENCRYPT_CHUNK))


def epoch_launches(n: int) -> dict:
    """Launches of each kernel in one N = 64 epoch: the encrypt ladders,
    ``EPOCH_SHA3_LAUNCHES`` SHA3 batches, ``EPOCH_BITPLANE_LAUNCHES``
    bit-plane products; Kernel 1 runs inside the ladder kernels, never on
    its own."""
    return {**encrypt_ladder_launches(n), "sha3_256": EPOCH_SHA3_LAUNCHES,
            "bitplane": EPOCH_BITPLANE_LAUNCHES, "fp_mul_lazy": 0}


def large_epoch_launches(n: int) -> dict:
    """Launches of each kernel in one scale-path epoch, from the code: the
    encrypt ladders, and per proposer chunk of the RBC round
    (``BatchedRbc._large_chunk_size``) one GF(2^16) encode (a bit-plane
    product) and one ``merkle_root``; stage B, which would encode and hash
    as much again, is skipped because every shard matches."""
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc

    chunks = n // BatchedRbc._large_chunk_size(n)
    return {**encrypt_ladder_launches(n), "sha3_256": chunks * merkle_root_levels(n),
            "bitplane": chunks, "fp_mul_lazy": 0}


def check_launches(launches: dict, expected: dict, what: str) -> None:
    """The launches of a run against those the code implies."""
    if launches != expected:
        raise AssertionError(f"{what} launches {launches}, expected {expected}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def ops_sum(counts, scale: int = 1):
    """The sum of (ALU, multiply-add, either) triples, times ``scale``."""
    return tuple(scale * sum(c[k] for c in counts) for k in range(3))


def ladder_ops(group: str, rows: int, nbits: int):
    """int32 instructions of a whole ladder: the step's operations as the
    kernel's schedule holds them (ops/ladder_schedule.py: shared and
    base-only operations counted once), every step, plus the prologue."""
    from hbbft_tpu_torch.ops import ladder_schedule as LS

    s = LS.build(group)
    kinds = ("MUL", "ADD", "SUB", "SEL")
    step = ops_sum([FP_KIND_OPS[kinds[op[0]]] for ls in s.lists for op in ls], nbits)
    once = ops_sum([FP_KIND_OPS[kinds[op[0]]] for op in s.prologue])
    return ops_sum([step, once], rows)


def ladder_window_ops(group: str, rows: int, nbits: int):
    """int32 instructions of a whole windowed ladder by its tables
    (ops/ladder_schedule.py): the table of 15 multiples (7 dbl and 7 addp
    steps, the prologue on each entry), then a window each 4 bits: 3 dbl
    steps and one step of the bitwise table.  The kernel's row copies are
    not work the function needs and are not counted."""
    from hbbft_tpu_torch.ops import ladder_schedule as LS

    kinds = ("MUL", "ADD", "SUB", "SEL")

    def table(kind):
        return ops_sum([FP_KIND_OPS[kinds[op[0]]]
                        for ls in LS.build(group, kind).lists for op in ls])

    step, dbl, addp = (table(k) for k in ("step", "dbl", "addp"))
    prologue = ops_sum([FP_KIND_OPS[kinds[op[0]]] for op in LS.build(group).prologue])
    windows = nbits // 4
    per_row = ops_sum([ops_sum([step], windows), ops_sum([dbl], 3 * windows + 7),
                       ops_sum([addp], 7), ops_sum([prologue], 15)])
    return ops_sum([per_row], rows)


def window_warp_instructions(group: str, rows: int, nbits: int, k: int, sass: dict) -> float:
    """Warp instructions the windowed kernel issues for its field operations
    at K = k: each table's operations (ladder_window_ops' count) times the
    SASS instructions of that operation at K (``kernel_field``), over the
    K rows a warp computes at once; the step machinery (waits, flags,
    barriers, copies) not counted."""
    from hbbft_tpu_torch.ops import ladder_schedule as LS

    kinds = ("MUL", "ADD", "SUB", "SEL")
    per_op = {**sass, "SEL": 0}

    def table(kind):
        return sum(per_op[kinds[op[0]]] for ls in LS.build(group, kind).lists for op in ls)

    prologue = sum(per_op[kinds[op[0]]] for op in LS.build(group).prologue)
    windows = nbits // 4
    per_row = (windows * table("step") + (3 * windows + 7) * table("dbl")
               + 7 * table("addp") + (windows + 1) * prologue)
    return rows * per_row / k


def ladder_bytes(rows: int, width: int, nbits: int) -> int:
    """A ladder's bytes: the base point read and the result written (3
    coordinates of 30 int32 digits over ``width`` columns), the bits read,
    base_inf read and inf written."""
    return 2 * 3 * 30 * width * 4 + rows * nbits * 4 + 2 * rows


def bound_ms(ctx, n_bytes: float, ops):
    """The larger of the bytes over HBM's rate and the instruction mix
    ``ops`` (ALU only, multiply-add, either pipe) over the int32 pipes."""
    alu, fma, either = ops
    clocks = max(alu / PIPE_PER_CLOCK_PER_SM, fma / PIPE_PER_CLOCK_PER_SM,
                 (alu + fma + either) / DISPATCH_PER_CLOCK_PER_SM)
    t_bytes = n_bytes / PEAK_BYTES_PER_S
    t_ops = clocks / ctx["sm_clocks_per_s"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, reps: int, rounds: int = 5) -> float:
    """Median over ``rounds`` of the CUDA-event time of ``reps`` calls,
    per call, after one warm call."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop) / reps)
    samples.sort()
    return samples[len(samples) // 2]


@contextlib.contextmanager
def profiling(torch):
    """A torch.profiler session over CPU and CUDA that begins with one tiny
    torch kernel.  On the card (torch 2.11) a session recorded every launch
    of one of this repo's kernels but the first, unless a torch kernel ran
    before it in the same session."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        yield prof
        torch.cuda.synchronize()


def device_ms_per_launch(torch, fn, kernel: str, calls: int = 20, tries: int = 3,
                         detail: dict | None = None):
    """Device time of one launch of ``kernel`` (a substring of its name),
    from torch.profiler over ``calls`` calls of ``fn`` (each call launches
    it once).  A session that records another number of launches than it
    made is taken again, up to ``tries`` sessions; None when none records
    them all (the launches a short session does record are mis-timed:
    PERF.md, run Q1).  ``detail`` (when given) gets the most launches a
    session recorded."""
    fn()
    torch.cuda.synchronize()
    most = 0
    for _ in range(tries):
        with profiling(torch) as prof:
            for _ in range(calls):
                fn()
        hits = [e for e in prof.key_averages() if kernel in e.key and e.count]
        recorded = sum(e.count for e in hits)
        most = max(most, recorded)
        if recorded == calls:
            break
    if detail is not None:
        detail.update({"launches_made": calls, "launches_recorded": most})
    if most != calls:
        return None
    return sum(e.self_device_time_total for e in hits) / calls / 1e3


def event_ms_per_launch(torch, fn, calls: int = 5) -> float:
    """Median over ``calls`` single calls of ``fn`` of the CUDA-event time
    between an event recorded just before it and one just after, each call
    waited for: for a kernel of a millisecond or more, one launch's device
    time (torch.profiler lost some sessions' records on the H100 of PERF.md)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        samples.append(start.elapsed_time(stop))
    return statistics.median(samples)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------- phases


def phase_build(ctx):
    from hbbft_tpu_torch import _build

    native = {}

    def build_native():
        t0 = time.perf_counter()
        from hbbft_tpu_torch.native import get_oracle

        get_oracle()
        native["seconds"] = time.perf_counter() - t0

    th = threading.Thread(target=build_native)
    t0 = time.perf_counter()
    th.start()
    built = _build.build_all(force=True)
    th.join()
    for name in _build.KERNELS:
        _build.lib(name)
    if "seconds" not in native:
        raise RuntimeError("native oracle build failed")
    return {
        "seconds": time.perf_counter() - t0,
        "nvcc": {k: {"seconds": v["seconds"], "ptxas": v["ptxas"]} for k, v in built.items()},
        "native_oracle_seconds": native["seconds"],
        "smi": ctx["smi"],
    }


def phase_lint(ctx):
    cmd = [sys.executable, "-m", "hbbft_tpu_torch.lint", "--json"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    if proc.returncode not in (0, 1):  # 1: findings, in the document
        raise RuntimeError(f"hblint exited {proc.returncode}: {proc.stderr[-2000:]}")
    doc = json.loads(proc.stdout)
    summary = doc["summary"]
    if summary["findings"] or summary["stale_baseline"]:
        raise RuntimeError(f"hblint: {summary['findings']} findings, "
                           f"{summary['stale_baseline']} stale baseline entries: "
                           f"{doc['findings'][:5]}")
    return {"lint_seconds": seconds, "checkers": doc["checkers"],
            **{k: summary[k] for k in ("findings", "baselined", "suppressed",
                                       "files_scanned", "stale_baseline")}}


def phase_kernel_fp(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import fp_lazy

    dev = torch.device("cuda")
    fold = F.consts(dev).fold
    rng = np.random.default_rng(1)
    rows = {}
    max_err = 0
    for R in (1, 63, 128, 256, 384, 8192):
        a = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        b = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        a[:, 0] = b[:, 0] = 1 << 13
        ta = torch.from_numpy(a).to(dev)
        tb = torch.from_numpy(b).to(dev)
        got = fp_lazy.fp_mul_lazy(ta, tb)
        ref = fp_lazy.mul_lazy_cols(ta, tb, fold)
        torch.cuda.synchronize()
        err = int((got.long() - ref.long()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"fp_mul_lazy differs from its plain version at R={R}")
        ms = time_ms(torch, lambda: fp_lazy.fp_mul_lazy(ta, tb), 200)
        plain_ms = time_ms(torch, lambda: fp_lazy.mul_lazy_cols(ta, tb, fold), 20)
        bms, by = bound_ms(ctx, FP_BYTES_PER_ROW * R, ops_sum([FP_KIND_OPS["MUL"]], R))
        rows[R] = {"ms": ms, "us": ms * 1e3, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by}
        if R in (256, 8192):  # the timing loop is bound by host dispatch
            rows[R]["device_ms_per_launch"] = device_ms_per_launch(
                torch, lambda: fp_lazy.fp_mul_lazy(ta, tb), "fp_mul_lazy_kernel")
    ctx["fp"] = {"max_abs_err": max_err, "rows": rows}
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "by_rows": rows}


def phase_kernel_sha3(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch.ops import keccak

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    checked = []
    max_err = 0

    def check(msgs, t):
        """Kernel 2 on ``t`` against its plain version on the same tensor
        (every row, exact) and against hashlib (three rows)."""
        nonlocal max_err
        M, L = msgs.shape
        got = keccak.sha3_256(t)
        ref = keccak.sha3_256_plain(t)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"sha3 kernel differs from its plain version at {M}x{L}")
        got_h = got.cpu().numpy()
        for i in sorted({0, M // 2, M - 1}):
            if got_h[i].tobytes() != hashlib.sha3_256(msgs[i].tobytes()).digest():
                raise AssertionError(f"sha3 kernel differs from hashlib at {M}x{L}")
        checked.append([L, M])

    leaf = ctx["leaf_bytes"]
    for L, batches in ((0, (1, 4096)), (64, (1, 2048)), (135, (1, 4096)),
                       (136, (1, 4096)), (137, (1, 4096)), (leaf, (1, 4096, 4097)),
                       (2930, (1, 4096)), (65536, (1, 512))):
        for M in batches:
            msgs = rng.integers(0, 256, (M, L), dtype=np.uint8)
            check(msgs, torch.from_numpy(msgs).to(dev))
    # times at the epochs' shapes: the 4096 Merkle leaves of one N = 64 RBC
    # round and the 2048 pairs of its first interior level, and the leaves
    # of one 64-proposer chunk at N = 1024 (65 536) and at N = 4096
    # (262 144 of 2 B), each checked again on the very tensor that is timed
    shapes = {}
    leaf_large, leaf_4096 = ctx["leaf_bytes_large"], ctx["leaf_bytes_4096"]
    for M, L in ((4096, leaf), (2048, 64), (N_LARGE * 64, leaf_large),
                 (N_4096 * 64, leaf_4096)):
        msgs = rng.integers(0, 256, (M, L), dtype=np.uint8)
        t = torch.from_numpy(msgs).to(dev)
        check(msgs, t)
        ms = time_ms(torch, lambda: keccak.sha3_256(t), 20)
        dev_ms = device_ms_per_launch(torch, lambda: keccak.sha3_256(t), "sha3_256_kernel")
        plain_ms = time_ms(torch, lambda: keccak.sha3_256_plain(t), 1, rounds=3)
        nblocks = L // keccak.RATE_BYTES + 1
        bms, by = bound_ms(ctx, M * (L + 32), ops_sum([SHA3_OPS_PER_BLOCK], M * nblocks))
        shapes[f"{M}x{L}"] = {"ms": ms, "us": ms * 1e3, "device_ms_per_launch": dev_ms,
                              "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by}
    ctx["sha3"] = {"max_abs_err": max_err, "shapes": shapes,
                   "main": f"4096x{ctx['leaf_bytes']}",
                   "main_n1024": f"{N_LARGE * 64}x{leaf_large}",
                   "main_n4096": f"{N_4096 * 64}x{leaf_4096}"}
    return {"max_abs_err": max_err, "tolerance": 0, "byte_exact": True, "checked": checked,
            "by_shape": shapes}


def bitplane_work(ctx, batch: int, rows: int, d: int, cols: int, mats: int):
    """The bit-plane product's work and its bounds: ``batch`` x ``rows``
    data rows of ``d`` bits against ``cols`` output columns, from ``mats``
    packed matrices (1 shared, or one a batch entry).  Bytes: each operand's
    ``ceil(d / 32)`` words a row or column read once, the packed output (a
    bit a column) written once.  Three operation rates against them:
    ``lop3`` (the ALU-pipe rule, kept so the figures compare with the
    earlier LOP3 kernel's: one LOP3, ``acc ^= a & m``, a row, column and
    32-bit word on the ALU pipe);
    ``int8_peak`` (a bit-product as one int8 multiply-add, 2 operations, at
    the data sheet's 1 979 TOP/s); ``b1_measured`` (a bit-product at the
    1-bit tensor rate this run's probe measured, ``wgmma`` m64n128k256: no
    rate is published; measured here when no phase of this run has).
    ``bound_ms`` is the last, the least time the card was seen to allow."""
    bitplane_probe_line(ctx)
    words = -(-d // 32)
    n_bytes = 4 * words * (batch * rows + mats * cols) + batch * rows * cols // 8
    n_ops = (batch * rows * words * cols, 0, 0)
    bits = batch * rows * d * cols
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    lop3_ms, lop3_by = bound_ms(ctx, n_bytes, n_ops)
    rec = {"bytes": n_bytes, "lop3": n_ops[0], "bit_products": bits,
           "bound_lop3_ms": lop3_ms, "bound_lop3_by": lop3_by,
           "shape": {"batch": batch, "rows": rows, "bits": d, "words": words,
                     "cols": cols, "matrices": mats}}
    for key, t_ops in (("int8_peak", 2 * bits / INT8_PEAK_OPS_PER_S * 1e3),
                       ("b1_measured", bits / ctx["b1_rate"] * 1e3)):
        rec[f"bound_{key}_ms"] = max(t_bytes, t_ops)
        rec[f"bound_{key}_by"] = "bytes" if t_bytes >= t_ops else "operations"
    rec["bound_ms"], rec["bound_by"] = rec["bound_b1_measured_ms"], rec["bound_b1_measured_by"]
    return rec


def bitplane_times(rec: dict, ms: float) -> dict:
    """``rec`` (from :func:`bitplane_work`) with the kernel's ``ms`` and its
    share of each bound."""
    rec["ms"] = ms
    for key in ("lop3", "int8_peak", "b1_measured"):
        rec[f"share_of_{key}_bound"] = rec[f"bound_{key}_ms"] / ms
    rec["share_of_bound"] = rec["bound_ms"] / ms
    return rec


def bitplane_plan_of(a, m) -> dict:
    """The launch plan ``gf256.bitplane_packed(a, m)`` makes (its route, as
    its wrapper folds a shared matrix's batch into rows)."""
    from hbbft_tpu_torch.ops import gf256

    if m.shape[:-2].numel() == 1:
        batch, rows = 1, a.shape[:-1].numel()
    else:
        batch, rows = a.shape[:-2].numel(), a.shape[-2]
    plan = gf256.bitplane_plan(batch, rows, a.shape[-1], m.shape[-2])
    plan["route"] = "resident" if plan["resident"] else "streamed"
    return plan


# the probe's work a block a round: mma.sync (8 warps x 8 products of
# 16 x 8 x 256 bits), wgmma (2 warpgroups x 16 products of 64 x 128 x 256)
PROBE_BITS = {0: 8 * 8 * 16 * 8 * 256, 1: 2 * 16 * 64 * 128 * 256}
PROBE_NAMES = {0: "mma_sync_m16n8k256_b1_and_popc", 1: "wgmma_m64n128k256_b1_and_popc"}
PROBE_BLOCKS_PER_SM = {0: 4, 1: 1}


def bitplane_probe_rates(ctx) -> dict:
    """The card's 1-bit tensor rates, from ``csrc/bitplane.cu``'s probe:
    bit-products a second of each form, on every SM, over a run of about
    50 ms (CUDA events, best of 3), against the LOP3 pipe's rate and the
    int8 peak's multiply-adds."""
    import torch

    from hbbft_tpu_torch.ops import gf256

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lop3 = 32 * PIPE_PER_CLOCK_PER_SM * ctx["sm_clocks_per_s"]
    out = {"lop3_bit_products_per_s": lop3, "int8_peak_macs_per_s": INT8_PEAK_OPS_PER_S / 2}
    for kind, name in PROBE_NAMES.items():
        blocks = sms * PROBE_BLOCKS_PER_SM[kind]
        buf = torch.empty(256 * blocks, dtype=torch.int32, device="cuda")

        def run(iters):
            best = None
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                gf256.bitplane_probe(kind, blocks, iters, buf)
                stop.record()
                stop.synchronize()
                t = start.elapsed_time(stop)
                best = t if best is None else min(best, t)
            return best

        first = run(256)
        iters = max(256, int(256 * 50.0 / max(first, 1e-3)))
        ms = run(iters)
        rate = blocks * iters * PROBE_BITS[kind] / (ms / 1e3)
        out[name] = {"blocks": blocks, "iters": iters, "ms": ms, "bit_products_per_s": rate,
                     "vs_lop3": rate / lop3, "vs_int8_peak_macs": rate / (INT8_PEAK_OPS_PER_S / 2)}
    return out


def _bitplane_cases(torch, dev):
    """The bit-plane kernel's operands at the shapes its paths give it, from
    coders of their own (the shared coders' device caches stay cold for the
    epochs' build timings): name → (packed data, packed matrix, contraction
    bits, number of matrices, the GF(2^16) parity matrix on the card or
    None)."""
    import numpy as np

    from hbbft_tpu_torch.ops import gf16, gf256, rs
    from hbbft_tpu_torch.parallel.mesh import RECEIVER_CHUNK_BYTES

    rng = np.random.default_rng(15)
    cases = {}
    # N = 64 (GF(2^8)): one RBC encode, 64 proposers x 22 data shards of
    # the epoch's shard length (the rows are byte positions)
    k, r = N_NODES - 2 * 21, 2 * 21
    B = shard_bytes(CIPHERTEXT_BYTES, k)
    coder = rs.ReedSolomon(k, r)
    data = torch.from_numpy(rng.integers(0, 256, (N_NODES, k, B), dtype=np.uint8)).to(dev)
    pm = coder._on(dev)
    cases["n64_encode"] = (gf256.pack_bytes(data.transpose(-1, -2), pm.shape[-1]), pm, 8 * k, 1,
                           None)
    # a masked decode: the mesh round's receiver chunk (receivers x 64
    # proposers, one 176 x 176 decode matrix each, the survivors drawn at
    # random)
    recv = max(1, RECEIVER_CHUNK_BYTES // (N_NODES * N_NODES * B))
    order = rng.random((recv, N_NODES, N_NODES)).argsort(-1)[..., :k]
    use = torch.from_numpy(np.sort(order, axis=-1)).to(dev)
    dec, ok = gf256.gf_inv_matrix_torch(coder.matrix_on(dev)[use])
    if not bool(ok.all()):
        raise AssertionError("bit-plane cases: a singular survivor matrix")
    pdec = gf256.pack_matrix(gf256.gf_matrix_to_bits_torch(dec))
    surv = torch.from_numpy(rng.integers(0, 256, (recv, N_NODES, B, k), dtype=np.uint8)).to(dev)
    cases["masked_decode"] = (gf256.pack_bytes(surv, pdec.shape[-1]), pdec, 8 * k,
                              recv * N_NODES, None)
    # one 64-proposer chunk of the GF(2^16) scale path at N = 1024 (shards of
    # 190 B: 95 symbol rows a proposer) and at N = 4096 (shards of 2 B)
    for name, n, f, value_bytes in (("n1024_chunk", N_LARGE, F_LARGE, CIPHERTEXT_BYTES),
                                    ("n4096_chunk", N_4096, F_4096, 294 + CONTRIB_BYTES_4096)):
        k = n - 2 * f
        B = shard_bytes(value_bytes, k)
        coder16 = rs.ReedSolomon16(k, 2 * f)
        pm = coder16._on(dev)
        parity = torch.from_numpy(coder16.parity_matrix.astype(np.int32)).to(dev)
        data = torch.from_numpy(rng.integers(0, 256, (64, k, B), dtype=np.uint8)).to(dev)
        cases[name] = (gf16.pack_shards(data, pm.shape[-1]), pm, 16 * k, 1, parity)
    return cases


def shard_bytes(value_bytes: int, k: int) -> int:
    """The RBC's shard length for values of ``value_bytes`` over k data shards."""
    from hbbft_tpu_torch.parallel.rbc import _frame_shard_len

    return _frame_shard_len([bytes(value_bytes)], k)


def bitplane_probe_line(ctx) -> None:
    """Measure the 1-bit tensor rates once a run (``ctx["b1_rate"]``, the
    faster form's) and print them on a line of their own."""
    if "b1_rate" in ctx:
        return
    probe = bitplane_probe_rates(ctx)
    ctx["b1_rate"] = max(v["bit_products_per_s"] for k, v in probe.items()
                         if k in PROBE_NAMES.values())
    ctx["bitplane_probe"] = probe
    emit({"bitplane_probe": probe, "b1_rate_for_bounds": ctx["b1_rate"], "card": ctx["smi"]})


def phase_kernel_bitplane(ctx):
    """The bit-plane kernel (``csrc/bitplane.cu``) against its plain version
    on the card, bit-exact, at the shapes its paths give it
    (``_bitplane_cases``), after the probe's line (the card's 1-bit tensor
    rates); each shape timed by CUDA events beside its three bounds
    (:func:`bitplane_work`), the plain version, and the library calls on the
    unpacked operands: the float32 ``torch.matmul`` and, where its shape
    rules allow, ``torch._int_mm`` of the int8 bits (each result ``& 1``, as
    the plain version takes it), with the launch plan (route, tiles) it
    took and the profiler's device time a launch (``ms`` is a call through
    the wrapper back to back, host work included).  At the GF(2^16) shapes
    the kernel's output is also held against the float32 product with the
    bit matrix ``gf16.parity_bits_f32`` builds on the card, unpacked by no
    packing code: a check of the packed matrix the coder built there."""
    import torch

    from hbbft_tpu_torch.ops import gf16, gf256

    bitplane_probe_line(ctx)
    dev = torch.device("cuda")
    cases = _bitplane_cases(torch, dev)
    out, max_err = {}, 0
    for name, (a, m, d, mats, parity) in cases.items():
        got = gf256.bitplane_packed(a, m)
        ref = gf256.bitplane_packed_plain(a, m)
        torch.cuda.synchronize()
        err = int((got.int() - ref.int()).abs().max())
        if parity is not None:
            f32 = gf256.bitplane_parity_plain(gf256.unpack_bits(a, d), gf16.parity_bits_f32(parity))
            err = max(err, int((got.int() - gf256.bits_to_bytes(f32).int()).abs().max()))
            del f32
        max_err = max(max_err, err)
        if err:
            raise AssertionError(f"bitplane kernel differs from its plain version at {name}")
        # a shared matrix multiplies every batch entry's rows as rows of one
        # product; decode matrices, one a batch entry, a product each
        batch = 1 if mats == 1 else a.shape[:-2].numel()
        rows, cols = a.shape[:-1].numel() // batch, m.shape[-2]
        del ref
        rec = bitplane_times(bitplane_work(ctx, batch, rows, d, cols, mats),
                             time_ms(torch, lambda: gf256.bitplane_packed(a, m), 10, rounds=3))
        rec["plan"] = bitplane_plan_of(a, m)
        rec["device_ms_per_launch"] = device_ms_per_launch(
            torch, lambda: gf256.bitplane_packed(a, m), "bitplane")
        rec["plain_ms"] = time_ms(torch, lambda: gf256.bitplane_packed_plain(a, m), 1, rounds=3)
        # the library calls, on the operands unpacked once outside the timing
        bits = gf256.unpack_bits(a, 32 * a.shape[-1]).to(torch.float32)
        mat = gf256.unpack_matrix(m, 32 * a.shape[-1]).to(torch.float32)
        f32_ms = time_ms(torch, lambda: torch.matmul(bits, mat).to(torch.int32) & 1, 1, rounds=3)
        del bits, mat
        int_mm = {"ms": None}
        if mats == 1:
            bits8 = gf256.unpack_bits(a, 32 * a.shape[-1]).reshape(rows, -1).contiguous()
            mat8 = gf256.unpack_bits(m, 32 * a.shape[-1]).reshape(cols, -1).t()
            try:
                int_mm["ms"] = time_ms(torch, lambda: torch._int_mm(bits8, mat8) & 1, 1,
                                       rounds=3)
            except RuntimeError as exc:
                int_mm["refused"] = str(exc).splitlines()[0][:160]
            del bits8, mat8
        else:
            int_mm["refused"] = "torch._int_mm takes one 2-D product, not a batch"
        library = [t for t in (f32_ms, int_mm["ms"]) if t is not None]
        rec.update({"library_ms": min(library), "library_float32_matmul_ms": f32_ms,
                    "library_int_mm": int_mm})
        out[name] = rec
        torch.cuda.empty_cache()
    ctx["bitplane"] = {"max_abs_err": max_err, "cases": out}
    return {"max_abs_err": max_err, "tolerance": 0, "bit_exact": True, "by_case": out}


FIELD_KINDS = {"MUL": 0, "ADD": 1, "SUB": 2}
FIELD_ROWS = (37, 4096)
FIELD_REPS = 4000


def sass_counts(lib_path: str) -> dict:
    """SASS instructions (NOPs not counted) of every function in a built
    library, by mangled name, from the toolkit's ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([exe, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            name = line.split(":", 1)[1].strip()
            counts[name] = 0
        elif name and line.startswith("/*") and "*/" in line:
            op = line.split("*/", 1)[1].strip().split(" ")[0]
            if op and not op.startswith("NOP") and not op.startswith("/*"):
                counts[name] += 1
    return counts


def field_sass_per_op(counts: dict) -> dict:
    """SASS instructions of one lazy MUL, ADD and SUB at K = 1, 2, 4: each
    field probe kernel less the empty probe (``ladder_window.cu`` ::
    lazy_op_probe), found by its mangled template arguments (K, kind)."""
    def probe(k, kind):
        tag = f"lazy_op_probeILi{k}EL" + (f"i{kind}E" if kind >= 0 else "in1E")
        (hit,) = [v for n, v in counts.items() if tag in n]
        return hit

    return {k: {name: probe(k, kind) - probe(k, -1) for name, kind in FIELD_KINDS.items()}
            for k in (1, 2, 4)}


def phase_kernel_field(ctx):
    """The lazy field at K = 1, 2 and 4 elements a warp, one operation a
    launch (the probe kernel of ``csrc/ladder_window.cu``, on no path),
    digit-exact against the plain field at 37 and 4 096 random rows with
    extreme digits; a warp's latency of each operation (the operation
    chained in one block); and the SASS instructions of each operation at
    each K (``cuobjdump -sass`` of the built library)."""
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import fp_lazy, ladder_lazy

    dev = torch.device("cuda")
    fold = F.consts(dev).fold
    plain = {"MUL": lambda a, b: fp_lazy.mul_lazy_cols(a, b, fold),
             "ADD": F.fp_add_lazy, "SUB": F.fp_sub_lazy}
    rng = np.random.default_rng(5)
    max_err, checked = 0, []
    for R in FIELD_ROWS:
        a = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        b = rng.integers(0, (1 << 13) + 1, (F.NL, R)).astype(np.int32)
        a[:, 0] = b[:, 0] = 1 << 13
        b[:, 1] = 0
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        for k in ladder_lazy.KS:
            for name, kind in FIELD_KINDS.items():
                got = ladder_lazy.lazy_op_probe(kind, ta, tb, k)
                err = int((got.long() - plain[name](ta, tb).long()).abs().max())
                max_err = max(max_err, err)
                if err:
                    raise AssertionError(f"lazy {name} at K = {k} differs from the plain field "
                                         f"at R={R}")
            checked.append([R, k])
    torch.cuda.synchronize()
    # a warp's latency of each operation: one block chains it FIELD_REPS
    # times (CUDA events around one launch), less the empty chain's time
    one = torch.from_numpy(rng.integers(0, (1 << 13) + 1, (F.NL, 4)).astype(np.int32)).to(dev)
    latency_ns = {}
    for k in ladder_lazy.KS:
        ms = {name: event_ms_per_launch(
                  torch, lambda: ladder_lazy.lazy_op_probe(kind, one[:, :k], one[:, :k], k,
                                                           FIELD_REPS), calls=3)
              for name, kind in {"none": -1, **FIELD_KINDS}.items()}
        latency_ns[k] = {name: (ms[name] - ms["none"]) * 1e6 / FIELD_REPS for name in FIELD_KINDS}
    sass = field_sass_per_op(sass_counts(_build._lib_path("ladder_window")))
    ctx["field_sass"], ctx["field_latency_ns"] = sass, latency_ns
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "checked": checked,
            "sass_per_op": sass, "latency_ns": latency_ns, "reps": FIELD_REPS}


def _ladder_rows(group: str, rows: int, rng):
    """Host points and scalars for one ladder launch: random half-scalars
    (< 2^128) on random multiples of the generator, with edge rows — from 4
    rows on, row 0 a zero scalar, row 1 all-ones bits and the last two rows
    base_inf padding; at 3 rows, all-ones bits first and base_inf last."""
    from hbbft_tpu_torch.crypto import bls12_381 as c

    ones = (1 << LADDER_BITS) - 1
    specials, n_pad = ([0, ones], 2) if rows >= 4 else (([ones], 1) if rows == 3 else ([], 0))
    mul, gen = (c.g1_mul, c.G1_GEN) if group == "g1" else (c.g2_mul, c.G2_GEN)
    pts = [mul(gen, rng.randrange(1, c.R)) for _ in range(rows - n_pad)] + [None] * n_pad
    scalars = specials + [rng.getrandbits(128) for _ in range(rows - len(specials))]
    return pts, scalars


# the ladder shapes of the N = 64 epoch (its encrypt: G1 rows = 2 × pad(2N),
# G2 rows = 2 × pad(N)).  No path runs this kernel: the N = 1024 shapes and
# the ragged row counts are left out (their plain ladders took ~30 s).
LADDER_ROWS = {"g1": (4 * N_NODES,), "g2": (2 * N_NODES,)}
LADDER_MAIN = 1  # the leading entries that are epoch shapes, each timed


def phase_kernel_ladder(ctx):
    """The bitwise kernel against the plain stepwise ladder and the native
    oracle at ``LADDER_ROWS``; no path runs it, the windowed kernel being
    the faster (``ladder_crossover``)."""
    import torch

    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.native import get_oracle
    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import gcurve as G

    dev = torch.device("cuda")
    nat = get_oracle()
    rng = random.Random(4)
    groups = {}
    max_err = 0
    for group in ("g1", "g2"):
        if group == "g1":
            ops, to_dev = G.LAZY_FP_OPS, G.g1_to_device
            from_dev, to_bytes, oracle_mul = G.g1_from_device_batch, c.g1_to_bytes, nat.bls_g1_mul
        else:
            ops, to_dev = G.LAZY_FP2_OPS, G.g2_to_device
            from_dev, to_bytes, oracle_mul = G.g2_from_device_batch, c.g2_to_bytes, nat.bls_g2_mul
        cases = [_ladder_rows(group, R, rng) for R in LADDER_ROWS[group]]
        launches = []
        for pts, scalars in cases:
            pt = to_dev(pts, dev)
            bits = torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev)
            base_inf = torch.tensor([p is None for p in pts], device=dev)
            launches.append((pt, bits, base_inf, G.scalar_mul_lazy(ops, pt, bits, base_inf)))
        torch.cuda.synchronize()

        def plain(idx):
            """The plain stepwise ladder, once over the rows of the cases
            ``idx`` together (it is row by row), and its wall time."""
            all_pts = [p for i in idx for p in cases[i][0]]
            pt_all = to_dev(all_pts, dev)
            bits_all = torch.from_numpy(
                F.bits_batch([s for i in idx for s in cases[i][1]], LADDER_BITS)).to(dev)
            inf_all = torch.tensor([p is None for p in all_pts], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = G.scalar_mul_lazy_plain(ops, pt_all, bits_all, inf_all)
            torch.cuda.synchronize()
            return ref, len(all_pts), (time.perf_counter() - t0) * 1e3

        # the reference: the ragged cases in one call, then each epoch
        # shape alone, whose time is the plain version's
        plain_ms = {}
        ragged = [range(LADDER_MAIN, len(cases))] if len(cases) > LADDER_MAIN else []
        for idx in ragged + [[i] for i in range(LADDER_MAIN)]:
            (ref, ref_inf), n_all, ms_all = plain(idx)
            if len(idx) == 1:
                plain_ms[idx[0]] = ms_all
            start = 0
            for i in idx:
                (pts, scalars), (pt, bits, base_inf, (out, inf)) = cases[i], launches[i]
                R = len(pts)
                cols = (torch.arange(start, start + R, device=dev) if group == "g1" else
                        torch.cat([torch.arange(start, start + R, device=dev),
                                   torch.arange(n_all + start, n_all + start + R, device=dev)]))
                err = max(int((g.long() - r[:, cols].long()).abs().max())
                          for g, r in zip(out, ref))
                max_err = max(max_err, err)
                if err or not torch.equal(inf, ref_inf[start:start + R]):
                    raise AssertionError(
                        f"{group} ladder kernel differs from the plain ladder at R={R}")
                inf_h = inf.cpu().tolist()
                want_inf = [s == 0 or p is None for p, s in zip(pts, scalars)]
                if inf_h != want_inf:
                    raise AssertionError(f"{group} ladder kernel: wrong infinity rows at R={R}")
                start += R
        shapes = []
        for i in range(LADDER_MAIN):
            pts, scalars = cases[i]
            pt, bits, base_inf, (out, inf) = launches[i]
            rows = len(pts)
            host = from_dev(out)
            inf_h = inf.cpu().tolist()
            checked = sorted({0, 1, 2, rows // 2, rows - 1})
            for r in checked:
                got = to_bytes(None if inf_h[r] else host[r])
                want = to_bytes(None) if pts[r] is None else oracle_mul(to_bytes(pts[r]), scalars[r])
                if got != want:
                    raise AssertionError(
                        f"{group} ladder kernel differs from the native oracle, row {r} of {rows}")
            ms = time_ms(torch, lambda: G.scalar_mul_lazy(ops, pt, bits, base_inf), 5, rounds=3)
            recorded = {}
            dev_ms = device_ms_per_launch(
                torch, lambda: G.scalar_mul_lazy(ops, pt, bits, base_inf), "ladder_lazy_kernel",
                calls=5, detail=recorded)
            ev_ms = event_ms_per_launch(torch, lambda: G.scalar_mul_lazy(ops, pt, bits, base_inf))
            n_bytes = ladder_bytes(rows, out[0].shape[1], LADDER_BITS)
            n_ops = ladder_ops(group, rows, LADDER_BITS)
            bms, by = bound_ms(ctx, n_bytes, n_ops)
            shapes.append({"rows": rows, "bits": LADDER_BITS, "ms": ms,
                           "device_ms_per_launch": dev_ms, "profiler": recorded,
                           "event_ms_per_launch": ev_ms, "plain_ms": plain_ms[i],
                           "bound_ms": bms, "bound_by": by, "bytes": n_bytes, "ops": n_ops,
                           "oracle_rows": checked})
        groups[group] = {**shapes[0],
                         "ragged_rows_checked": list(LADDER_ROWS[group][LADDER_MAIN:])}

    def pair(shape_of):
        both = bound_ms(ctx, sum(shape_of(g)["bytes"] for g in groups.values()),
                        ops_sum([shape_of(g)["ops"] for g in groups.values()]))
        return {
            "ms": sum(shape_of(g)["ms"] for g in groups.values()),
            "plain_ms": sum(shape_of(g)["plain_ms"] for g in groups.values()),
            "bound_ms": both[0], "bound_by": both[1],
            "device_ms_per_launch": {k: shape_of(g)["device_ms_per_launch"]
                                     for k, g in groups.items()},
            "event_ms_per_launch": {k: shape_of(g)["event_ms_per_launch"]
                                    for k, g in groups.items()},
            "ms_by_group": {k: shape_of(g)["ms"] for k, g in groups.items()},
            "rows": {k: shape_of(g)["rows"] for k, g in groups.items()},
        }

    ctx["ladder"] = {"max_abs_err": max_err, **pair(lambda g: g)}
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "inf_exact": True,
            "by_group": groups}


def _epoch64_inputs():
    """The N = 64 epoch's network and 64 000-byte contributions."""
    import numpy as np

    from hbbft_tpu_torch.netinfo import NetworkInfo

    ids = list(range(N_NODES))
    nets = NetworkInfo.generate_map(ids, random.Random(7))
    rng = np.random.default_rng(3)
    return nets, {i: rng.integers(0, 256, CONTRIB_BYTES, dtype=np.uint8).tobytes() for i in ids}


def phase_epoch(ctx):
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    nets, contribs = _epoch64_inputs()
    ep = BatchedHoneyBadgerEpoch(nets, device="cuda", encrypt_backend="device")

    # warm run, split so its ciphertexts can be held against the native
    # oracle's encrypt under the same scalars; that reference encrypt runs
    # between the two timed halves and is not part of warm_epoch_s
    t0 = time.perf_counter()
    payloads = ep.encrypt_phase(contribs, random.Random(11))
    torch.cuda.synchronize()
    warm_encrypt_s = time.perf_counter() - t0
    pk = nets[0].public_key_set().public_key()
    native = [
        ct.to_bytes() for ct in tc.tpke_encrypt_batch(
            pk, [contribs[i] for i in ep.ids], random.Random(11), backend="native",
            device="cpu",
        )
    ]
    if payloads != native:
        raise AssertionError("device-route ciphertexts differ from the native oracle's")
    t0 = time.perf_counter()
    batch, _ = ep.run_from_payloads(payloads)
    torch.cuda.synchronize()
    warm_s = warm_encrypt_s + time.perf_counter() - t0
    if batch != contribs:
        raise AssertionError("warm epoch did not return every contribution")

    expected = epoch_launches(N_NODES)
    timed = []
    for k in range(TIMED_EPOCHS):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        batch, detail = ep.run(contribs, random.Random(12 + k), timer=time.perf_counter)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if batch != contribs:
            raise AssertionError("timed epoch did not return every contribution")
        if not np.asarray(detail["accepted"]).all():
            raise AssertionError("a node did not accept every instance")
        check_launches(launches, expected, "epoch")
        timed.append({"epoch_s": epoch_s, "phase_s": detail["phase_s"],
                      "aba_epochs": detail["epochs"]})
    ctx["launches"] = launches
    ctx["epoch"] = (ep, payloads, contribs)
    return {
        "n": N_NODES, "f": nets[0].num_faulty(), "contribution_bytes": CONTRIB_BYTES,
        "payload_bytes": detail["payload_bytes"],
        "epoch_s_median": statistics.median(t["epoch_s"] for t in timed),
        "timed": timed,
        "warm_epoch_s": warm_s, "warm_encrypt_s": warm_encrypt_s,
        "launches_per_epoch": launches, "ladder_launches_per_epoch":
            sum(launches[k] for k in LADDER_KERNELS), "batch_ok": True,
        "ciphertexts_match_native": True,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


# kernels by kind, as substrings of the names torch.profiler records
KERNEL_KINDS = {"ladder_lazy": "ladder_lazy_kernel", "ladder_window": "ladder_window_kernel",
                "ladder_mxu": "ladder_mxu_kernel",
                "sha3_256": "sha3_256_kernel", "bitplane": "bitplane_wgmma",
                "fp_mul_lazy": "fp_mul_lazy_kernel"}


def _kernel_events(torch, prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]


def _device_ms_by_kind(kernels, calls: int = 1):
    """Device ms (per call) of the profiled kernels of each kind, and of all."""
    out = {kind: sum(e.self_device_time_total for e in kernels if sub in e.key.lower())
           / 1e3 / calls for kind, sub in KERNEL_KINDS.items()}
    out["all"] = sum(e.self_device_time_total for e in kernels) / 1e3 / calls
    return out


def _busy_share(torch, fn, wall=None):
    """Wall seconds of ``fn`` (timed bare, after a warm call; or ``wall``,
    when the caller timed it already), and the device-busy seconds of its
    kernels as torch.profiler records them in a profiled call (the
    profiler slows the host, not the kernels).  Busy is None when the
    profiler records no device time."""
    if wall is None:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with profiling(torch) as prof:
        fn()
    kernels = _kernel_events(torch, prof)  # with the session's one-launch primer
    busy = sum(e.self_device_time_total for e in kernels) / 1e6 if kernels else None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    ours = [e for e in kernels if e not in top and any(
        k in e.key for k in KERNEL_KINDS.values())]
    return {
        "wall_s": wall, "device_busy_s": busy,
        "idle_share": None if busy is None else 1 - busy / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "device_ms_by_kind": _device_ms_by_kind(kernels),
        "top": [{"name": e.key[:72], "device_ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in top + ours],
    }


# the encrypt phase's stages, by function name: the ladder dispatches
# (host conversions, endomorphisms, the launch) and collections (the wait
# for the kernel, host adds), the affine serialisation, the KDF + XOR, the
# native hash-to-G2, the ciphertext's serialisation.  (cProfile on this
# Python drops some outer frames, so the stages are inner functions.)
ENCRYPT_STAGES = ("_mul_batch_dispatch", "_mul_batch_collect", "_g1_to_bytes_batch",
                  "_xor_mask", "bls_hash_g2_batch", "to_bytes")


def _host_profile(torch, fn, stages, n: int = 8):
    """One call of ``fn`` under cProfile (which slows Python calls, not
    native code): the cumulative seconds of each function named in
    ``stages``, and the ``n`` functions with the most own time."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.enable()
    fn()
    torch.cuda.synchronize()
    prof.disable()
    stats = pstats.Stats(prof).stats  # (file, line, name) → (cc, calls, own, cumulative, …)
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:n]
    return {
        "stages_s": {s: sum(v[3] for (_, _, name), v in stats.items() if name == s)
                     for s in stages},
        "top_own": [{"fn": f"{os.path.basename(f)}:{line}:{name}", "calls": v[1],
                     "own_s": v[2], "cumulative_s": v[3]} for (f, line, name), v in top],
    }


def phase_profile(ctx):
    """Device busy share and kernel launches of the epoch's two parts, each
    in full as the epoch runs it: the encrypt phase (both ladders, the
    host's hash-to-G2, KDF and serialisation) and ACS + decrypt; and the
    encrypt phase's host time by stage."""
    import torch

    ep, payloads, contribs = ctx["epoch"]

    def encrypt():
        return ep.encrypt_phase(contribs, random.Random(5))

    enc = _busy_share(torch, encrypt)
    if enc["kernel_launches"] >= 1000:
        raise AssertionError(f"encrypt phase issued {enc['kernel_launches']} launches")
    enc["host"] = _host_profile(torch, encrypt, ENCRYPT_STAGES)
    return {"encrypt": enc,
            "acs_decrypt": _busy_share(torch, lambda: ep.run_from_payloads(payloads))}


# the qhb64 cell: the N = 64 network of ``epoch``, each node proposing
# QHB_BATCH transactions of QHB_TX_BYTES (a 65 028-byte contribution, the
# epoch cell's ~64 000 bytes) from a queue of QHB_FILL of its own
QHB_BATCH = 256
QHB_TX_BYTES = 250
QHB_FILL = 4 * QHB_BATCH
QHB_EPOCHS = 8


def _qhb_fill(drv, ids, seed: int) -> set:
    """Push QHB_FILL seeded transactions at each node (its id and index in
    the first 4 bytes, so all are distinct); returns the pushed set."""
    import struct

    import numpy as np

    rng = np.random.default_rng(seed)
    pushed = set()
    for nid in ids:
        body = rng.integers(0, 256, (QHB_FILL, QHB_TX_BYTES - 4), dtype=np.uint8)
        for j in range(QHB_FILL):
            tx = struct.pack(">HH", nid, j) + body[j].tobytes()
            drv.push(nid, tx)
            pushed.add(tx)
    return pushed


def _check_ledger(drv, pushed, what: str) -> None:
    """Every pushed transaction committed exactly once, nothing else."""
    if len(drv.committed) != len(set(drv.committed)):
        raise AssertionError(f"{what}: a transaction was committed twice")
    if set(drv.committed) != pushed or drv.pending():
        raise AssertionError(f"{what}: the committed set is not the pushed set")


def _spy_epochs(hb, first=None) -> dict:
    """Record, for each epoch ``hb`` runs, its largest payload and the
    seconds of its encrypt phase (on whichever thread runs it) and of its
    ACS + decrypt (the dict returned, lists in epoch order); with
    ``first``, hold the first epoch's payloads to it."""
    seen = {"payload_bytes": [], "encrypt_s": [], "acs_decrypt_s": []}
    encrypt_phase, run_from_payloads = hb.encrypt_phase, hb.run_from_payloads

    def timed_encrypt(*args, **kw):
        t0 = time.perf_counter()
        out = encrypt_phase(*args, **kw)
        seen["encrypt_s"].append(time.perf_counter() - t0)
        return out

    def timed_acs(payloads, **kw):
        seen["payload_bytes"].append(max(len(p) for p in payloads))
        if first is not None and len(seen["payload_bytes"]) == 1 and list(payloads) != first:
            raise AssertionError("qhb64: the first epoch's device ciphertexts differ "
                                 "from the native oracle's")
        t0 = time.perf_counter()
        out = run_from_payloads(payloads, **kw)
        seen["acs_decrypt_s"].append(time.perf_counter() - t0)
        return out

    hb.encrypt_phase, hb.run_from_payloads = timed_encrypt, timed_acs
    return seen


def phase_qhb64(ctx):
    """The queueing driver at N = 64 on the card, TPKE encrypt on the
    device route: 8 ``run_epochs_pipelined`` epochs (the next epoch's
    encrypt on a worker thread during this epoch's ACS), then
    ``run_to_empty``; then a fresh driver with the same fill for 8
    sequential ``run_epoch``s.  Gates: every pushed transaction committed
    once, launch totals of 2 windowed ladders and 21 SHA3 batches an
    epoch, and the pipelined run's first ciphertexts equal to the native
    oracle's under the same scalars."""
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.qhb import BatchedQueueingHoneyBadger
    from hbbft_tpu_torch.protocols.queueing_honey_badger import _ser_txs

    ids = list(range(N_NODES))
    nets = NetworkInfo.generate_map(ids, random.Random(7))
    per_epoch = epoch_launches(N_NODES)

    def driver():
        return BatchedQueueingHoneyBadger(
            nets, batch_size=QHB_BATCH, session_id=b"qhb64", device="cuda",
            encrypt_backend="device")

    driver().run_epoch(random.Random(0))  # warm: empty queues, every kernel once

    def timed_run(fn):
        """(result, wall s, launches, per-epoch (s, new txs)) of ``fn(on_epoch)``."""
        marks = []
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = fn(lambda e, new: marks.append((time.perf_counter(), len(new))))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        starts = [t0] + [m[0] for m in marks[:-1]]
        epochs = [{"s": m[0] - st, "new_txs": m[1]} for st, m in zip(starts, marks)]
        return out, wall, dict(_build.LAUNCHES), epochs

    # pipelined, then drained
    drv = driver()
    pushed = _qhb_fill(drv, ids, 17)
    rng = random.Random(23)
    probe = random.Random()
    probe.setstate(rng.getstate())
    seed = probe.getrandbits(48)  # the first epoch's seed, as run_epochs_pipelined draws it
    first = [_ser_txs(drv.queues[nid].choose(random.Random(seed ^ i), QHB_BATCH))
             for i, nid in enumerate(drv.ids)]
    pk = nets[0].public_key_set().public_key()
    native = [ct.to_bytes() for ct in tc.tpke_encrypt_batch(
        pk, first, random.Random(seed), backend="native", device="cpu")]
    pipe_split = _spy_epochs(drv.hb, native)
    _, pipe_s, pipe_launches, pipe_epochs = timed_run(
        lambda cb: drv.run_epochs_pipelined(rng, QHB_EPOCHS, on_epoch=cb))
    check_launches(pipe_launches, {k: v * QHB_EPOCHS for k, v in per_epoch.items()},
                   "qhb64 pipelined")
    drained, drain_s, drain_launches, drain_epochs = timed_run(
        lambda cb: drv.run_to_empty(rng, on_epoch=cb))
    check_launches(drain_launches, {k: v * drained for k, v in per_epoch.items()},
                   "qhb64 run_to_empty")
    _check_ledger(drv, pushed, "qhb64 pipelined")
    ctx["qhb64_launches"] = pipe_launches

    # sequential, same fill
    seq = driver()
    if _qhb_fill(seq, ids, 17) != pushed:
        raise AssertionError("qhb64: the two fills differ")
    rng = random.Random(23)

    def sequential(cb):
        for _ in range(QHB_EPOCHS):
            cb(seq.epoch, seq.run_epoch(rng))

    seq_split = _spy_epochs(seq.hb)
    _, seq_s, seq_launches, seq_epochs = timed_run(sequential)
    check_launches(seq_launches, {k: v * QHB_EPOCHS for k, v in per_epoch.items()},
                   "qhb64 sequential")
    _check_ledger(seq, pushed, "qhb64 sequential")
    return {
        "n": N_NODES, "f": nets[0].num_faulty(), "batch_size": QHB_BATCH,
        "tx_bytes": QHB_TX_BYTES, "txs_pushed": len(pushed),
        "contribution_bytes": len(first[0]),
        "pipelined": {"epochs": QHB_EPOCHS, "s": pipe_s, "epochs_per_s": QHB_EPOCHS / pipe_s,
                      "txs_per_s": len(pushed) / (pipe_s + drain_s),
                      "epoch_s": pipe_epochs, **pipe_split,
                      "launches": pipe_launches,
                      "then_run_to_empty": {"epochs": drained, "s": drain_s,
                                            "epoch_s": drain_epochs}},
        "sequential": {"epochs": QHB_EPOCHS, "s": seq_s, "epochs_per_s": QHB_EPOCHS / seq_s,
                       "txs_per_s": len(pushed) / seq_s, "epoch_s": seq_epochs,
                       **seq_split, "launches": seq_launches},
        "committed_once": True, "ciphertexts_match_native": True,
        "auto_encrypt_route_n64": "device" if B.device_encrypt_worthwhile(N_NODES, "cuda")
        else "native",
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _merkle_root_host(leaves) -> bytes:
    """The Merkle root of ``ops/merkle.py``'s tree, with hashlib."""
    level = [hashlib.sha3_256(x).digest() for x in leaves]
    while len(level) > 1:
        nxt = [hashlib.sha3_256(level[i] + level[i + 1]).digest()
               for i in range(0, len(level) - 1, 2)]
        level = nxt + level[-1:] if len(level) % 2 else nxt
    return level[0]


def phase_rbc_large(ctx):
    """The scale path alone: ``BatchedRbc(1024, 341)`` over 1 024 proposers
    of 64 294-byte values (the epoch's ciphertext size) — full delivery,
    data shards altered after the commit, a framing fault."""
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.ops import rs
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc, unframe_value

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rbc = BatchedRbc(N_LARGE, F_LARGE)
    coder_s = time.perf_counter() - t0
    if not (rbc.large and type(rbc.coder) is rs.ReedSolomon16
            and rs.for_n_f(N_LARGE, F_LARGE) is rbc.coder):
        raise AssertionError("N = 1024 did not select the GF(2^16) coder")
    n, k, P = N_LARGE, rbc.k, N_LARGE
    rng = np.random.default_rng(21)
    values = [rng.integers(0, 256, CIPHERTEXT_BYTES, dtype=np.uint8).tobytes()
              for _ in range(P)]
    data = rbc.upload_framed(values, dev)
    B = data.shape[-1]
    if B != ctx["leaf_bytes_large"]:
        raise AssertionError(f"shard length {B}, expected {ctx['leaf_bytes_large']}")
    round_launches = large_epoch_launches(P)
    sha3_round, bitplane_round = round_launches["sha3_256"], round_launches["bitplane"]

    def run(d, **kw):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        out = rbc.run(d, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(_build.LAUNCHES)

    def unframes_all(out, skip=()):
        return all(unframe_value(out["data"][0, p]) == values[p]
                   for p in range(P) if p not in skip)

    # (a) full delivery: every verdict, every value; four proposers' shards
    # from stage A against the host encoder, their roots against hashlib
    out, full_s, launches = run(data)
    if not (out["delivered"].all() and not out["fault"].any()
            and (out["echo_count"] == n).all() and (out["ready_count"] == n).all()):
        raise AssertionError("full delivery: not every proposer delivered")
    if launches["sha3_256"] != sha3_round or launches["bitplane"] != bitplane_round \
            or not unframes_all(out):
        raise AssertionError(f"full delivery: launches {launches} or a value differs")
    check = [0, 1, P // 2 + 1, P - 1]
    sent, root, *_ = rbc.large_stage_a(data[check], None, None, len(check))
    sent_h, root_h, host_data = sent.cpu().numpy(), root.cpu().numpy(), data[check].cpu().numpy()
    for i, p in enumerate(check):
        want = rbc.coder.encode_np(host_data[i])
        if not np.array_equal(sent_h[i], want):
            raise AssertionError(f"proposer {p}: device shards differ from encode_np")
        want_root = _merkle_root_host([row.tobytes() for row in want])
        if root_h[i].tobytes() != want_root or out["root"][p].tobytes() != want_root:
            raise AssertionError(f"proposer {p}: root differs from hashlib's")

    # the GF(2^16) encode of one proposer chunk, timed alone
    chunk = data[: rbc._large_chunk_size(P)]
    enc_ms = time_ms(torch, lambda: rbc.coder.encode(chunk), 5, rounds=3)
    with profiling(torch) as prof:
        for _ in range(5):
            rbc.coder.encode(chunk)
    enc_dev = _device_ms_by_kind(_kernel_events(torch, prof), calls=5)
    product = bitplane_work(ctx, 1, chunk.shape[0] * (B // 2), 16 * k, 16 * (n - k), 1)

    # (b) data shards altered after the commit at three proposers (two
    # survivor patterns): the straggler decode on the host, then stage B
    vt = torch.zeros((P, n, B), dtype=torch.uint8, device=dev)
    tampered = {5: (3, 0, 0xFF), P // 2: (0, 7, 0x01), P - 2: (k - 1, 2, 0x40)}
    for p, (row, col, v) in tampered.items():
        vt[p, row, col] = v
    out, tamper_s, launches_b = run(data, value_tamper=vt)
    ec = out["echo_count"][0]
    want_ec = np.full(P, n)
    want_ec[list(tampered)] = n - 1
    if not (out["delivered"].all() and not out["fault"].any() and np.array_equal(ec, want_ec)):
        raise AssertionError("data-shard tamper: wrong verdicts or echo counts")
    # stage A and stage B each encode and hash every chunk; the stragglers
    # decode on the host
    if launches_b["sha3_256"] != 2 * sha3_round or launches_b["bitplane"] != 2 * bitplane_round \
            or not unframes_all(out):
        raise AssertionError(f"data-shard tamper: launches {launches_b} or a value differs")

    # (c) a framing fault: proposer 9's length prefix exceeds its payload
    bad = data.clone()
    bad[9, 0, :4] = 0xFF
    out, framing_s, launches_c = run(bad)
    d, fl = out["delivered"], out["fault"]
    if d[:, 9].any() or not fl[:, 9].all() or out["data"][0, 9].any():
        raise AssertionError("framing fault: proposer 9 was not faulted")
    if not (d[:, :9].all() and d[:, 10:].all() and unframes_all(out, skip=(9,))):
        raise AssertionError("framing fault: another proposer was not delivered")
    if launches_c["bitplane"] != bitplane_round:
        raise AssertionError(f"framing fault: launches {launches_c}")
    return {
        "n": n, "f": F_LARGE, "k": k, "proposers": P, "shard_bytes": B,
        "coder_s": coder_s, "full_delivery_s": full_s, "data_shard_tamper_s": tamper_s,
        "framing_fault_s": framing_s,
        "launches": {"full_delivery": launches, "data_shard_tamper": launches_b,
                     "framing_fault": launches_c},
        "shards_match_encode_np": check, "roots_match_hashlib": check,
        "tampered": {str(p): list(v) for p, v in tampered.items()},
        "gf16_encode_chunk": {"proposers": chunk.shape[0], "ms": enc_ms,
                              "device_ms": enc_dev, "bitplane": product},
    }


def _all_accepted(detail) -> bool:
    """Every node accepted every instance: the (N, P) ``accepted`` matrix,
    or under ``compact=True`` one agreed row of all True."""
    import numpy as np

    if "accepted" in detail:
        return bool(np.asarray(detail["accepted"]).all())
    return bool(detail["accepted_agree"] and np.asarray(detail["accepted_row"]).all())


def _scale_epochs(tag: str, ep, nets, contribs, warm_seed: int, timed_seeds,
                  profile_seed, expected: dict, keep: dict | None = None):
    """The scale-path epoch's gates and times: a warm run, split so that its
    ciphertexts can be held against the native oracle's encrypt under the
    same scalars (that reference encrypt is not part of warm_epoch_s); one
    timed run a seed of ``timed_seeds``, each with the launch counters reset
    just before it and read just after, its batch, acceptance and launches
    checked; then, unless ``profile_seed`` is None, one more epoch under the
    profiler, against the median wall of the bare timed epochs.  ``keep``
    (when given) gets the warm run's payloads.  Returns (result fields,
    launches)."""
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import tc

    t0 = time.perf_counter()
    payloads = ep.encrypt_phase(contribs, random.Random(warm_seed))
    torch.cuda.synchronize()
    warm_encrypt_s = time.perf_counter() - t0
    pk = nets[ep.ids[0]].public_key_set().public_key()
    native = [
        ct.to_bytes() for ct in tc.tpke_encrypt_batch(
            pk, [contribs[i] for i in ep.ids], random.Random(warm_seed), backend="native",
            device="cpu",
        )
    ]
    if payloads != native:
        raise AssertionError(f"{tag}: device-route ciphertexts differ from the native oracle's")
    del native
    if keep is not None:
        keep["payloads"] = payloads
    t0 = time.perf_counter()
    batch, _ = ep.run_from_payloads(payloads)
    torch.cuda.synchronize()
    warm_s = warm_encrypt_s + time.perf_counter() - t0
    if batch != contribs:
        raise AssertionError(f"{tag}: warm epoch did not return every contribution")

    timed = []
    for seed in timed_seeds:
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        batch, detail = ep.run(contribs, random.Random(seed), timer=time.perf_counter)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if batch != contribs:
            raise AssertionError(f"{tag}: timed epoch did not return every contribution")
        if not _all_accepted(detail):
            raise AssertionError(f"{tag}: a node did not accept every instance")
        check_launches(launches, expected, f"{tag} epoch")
        timed.append({"epoch_s": epoch_s, "phase_s": detail["phase_s"],
                      "aba_epochs": detail["epochs"]})
    median = statistics.median(t["epoch_s"] for t in timed)
    busy = None if profile_seed is None else _busy_share(
        torch, lambda: ep.run(contribs, random.Random(profile_seed)), wall=median)
    return {
        "payload_bytes": detail["payload_bytes"], "epoch_s_median": median, "timed": timed,
        "warm_epoch_s": warm_s, "warm_encrypt_s": warm_encrypt_s,
        "launches_per_epoch": launches, "batch_ok": True, "all_accepted": True,
        "ciphertexts_match_native": True, "profiled_epoch": busy,
    }, launches


def phase_epoch1024(ctx):
    """HoneyBadger epochs at N = 1024 (f = 341, 64 000-byte contributions)
    through the scale path, with the TPKE encrypt ladders on the card."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    torch.cuda.reset_peak_memory_stats()
    ids = list(range(N_LARGE))
    t0 = time.perf_counter()
    nets = NetworkInfo.generate_map(ids, random.Random(7))
    keygen_s = time.perf_counter() - t0
    if nets[0].num_faulty() != F_LARGE:
        raise AssertionError(f"f = {nets[0].num_faulty()}, expected {F_LARGE}")
    rng = np.random.default_rng(13)
    contribs = {i: rng.integers(0, 256, CONTRIB_BYTES, dtype=np.uint8).tobytes() for i in ids}
    ep = BatchedHoneyBadgerEpoch(nets, device="cuda", encrypt_backend="device")
    res, ctx["launches_n1024"] = _scale_epochs(
        "N = 1024", ep, nets, contribs, 31, range(32, 32 + TIMED_EPOCHS_LARGE), 40,
        large_epoch_launches(N_LARGE))
    return {
        "n": N_LARGE, "f": F_LARGE, "k": ep.acs.rbc.k, "contribution_bytes": CONTRIB_BYTES,
        "keygen_s": keygen_s, **res, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def _net4096(ctx):
    """BASELINE config 5's network and contributions, made once a run as
    bench.py's ``_bench_hb_epoch_large(4096, 64, …)`` and ``sustained4096``
    make them: the keys from ``random.Random(23)``, then 64 bytes a node
    from the same generator.  Returns (nets, contributions, keygen s)."""
    from hbbft_tpu_torch.netinfo import NetworkInfo

    if "net4096" not in ctx:
        rng = random.Random(23)
        t0 = time.perf_counter()
        nets = NetworkInfo.generate_map(list(range(N_4096)), rng)
        keygen_s = time.perf_counter() - t0
        if nets[0].num_faulty() != F_4096:
            raise AssertionError(f"f = {nets[0].num_faulty()}, expected {F_4096}")
        contribs = {i: bytes(rng.randrange(256) for _ in range(CONTRIB_BYTES_4096))
                    for i in range(N_4096)}
        ctx["net4096"] = (nets, contribs, keygen_s)
    return ctx["net4096"]


def phase_epoch4096(ctx):
    """BASELINE config 5: HoneyBadger epochs at N = 4096 (f = 1365, 64-byte
    contributions, ``compact=True``, as bench.py's ``bench_hb_epoch4096``)
    through the scale path, the TPKE encrypt ladders on the card; the
    GF(2^16) coder's build (host matrix, then the bit matrix on the card)
    timed, with its device memory."""
    import torch

    from hbbft_tpu_torch.ops import rs
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    nets, contribs, keygen_s = _net4096(ctx)
    torch.cuda.synchronize()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    coder = rs.for_n_f(N_4096, F_4096)
    coder_host_s = time.perf_counter() - t0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bits = coder._on(dev)
    torch.cuda.synchronize()
    coder_device_s = time.perf_counter() - t0
    coder_mem = {"resident_bytes": torch.cuda.memory_allocated() - before,
                 "peak_bytes": torch.cuda.max_memory_allocated() - before,
                 "packed_matrix_shape": list(bits.shape)}
    torch.cuda.reset_peak_memory_stats()
    ep = BatchedHoneyBadgerEpoch(nets, session_id=b"hb-epoch4096", compact=True,
                                 device="cuda", encrypt_backend="device")
    if ep.acs.rbc.coder is not coder:
        raise AssertionError("the N = 4096 epoch did not take the coder built here")
    res, ctx["launches_n4096"] = _scale_epochs(
        "N = 4096", ep, nets, contribs, 1, range(2, 2 + TIMED_EPOCHS_4096), 2 + TIMED_EPOCHS_4096,
        large_epoch_launches(N_4096))
    return {
        "n": N_4096, "f": F_4096, "k": ep.acs.rbc.k, "contribution_bytes": CONTRIB_BYTES_4096,
        "compact": True, "keygen_s": keygen_s, "coder_host_s": coder_host_s,
        "coder_device_s": coder_device_s, "coder_device_mem": coder_mem,
        **res, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


def phase_epoch16384(ctx):
    """bench.py's ``bench_hb_epoch16384`` (``_bench_hb_epoch_large(16384,
    32, ...)``): N = 16384, f = 5461, the keys from ``random.Random(23)``,
    then 32 bytes a node from the same generator, ``compact=True``, session
    ``hb-epoch16384``, through the scale path with the TPKE encrypt ladders
    on the card.  Keygen and the GF(2^16) coder's build (the closed-form
    matrix on the host, the packed bit matrix on the card) timed, with the
    coder's device bytes; the bit-plane kernel timed at one 64-proposer
    chunk, held against its plain version (``_bitplane_sliced``);
    ``epoch4096``'s gates on one timed epoch (no profiled one); and
    the parity of three proposers' framed ciphertexts, as the epoch's
    stage A encodes them on the card, against the host ``encode_np``."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.ops import gf16, gf256, rs
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    n, f = N_16384, F_16384
    rng = random.Random(23)
    t0 = time.perf_counter()
    nets = NetworkInfo.generate_map(list(range(n)), rng)
    keygen_s = time.perf_counter() - t0
    if nets[0].num_faulty() != f:
        raise AssertionError(f"f = {nets[0].num_faulty()}, expected {f}")
    contribs = {i: bytes(rng.randrange(256) for _ in range(CONTRIB_BYTES_16384))
                for i in range(n)}
    torch.cuda.synchronize()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    coder = rs.for_n_f(n, f)
    coder_host_s = time.perf_counter() - t0
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bits = coder._on(dev)
    torch.cuda.synchronize()
    coder_device_s = time.perf_counter() - t0
    coder_mem = {"resident_bytes": torch.cuda.memory_allocated() - before,
                 "peak_bytes": torch.cuda.max_memory_allocated() - before,
                 "packed_matrix_shape": list(bits.shape),
                 "float32_bit_matrix_bytes": 4 * 16 * coder.data_shards * 16 * coder.parity_shards}

    # the kernel at one chunk's shape: 64 proposers of one 2-byte shard each
    k = coder.data_shards
    B = shard_bytes(294 + CONTRIB_BYTES_16384, k)
    chunk = torch.from_numpy(np.random.default_rng(16).integers(
        0, 256, (64, k, B), dtype=np.uint8)).to(dev)
    a = gf16.pack_shards(chunk, bits.shape[-1])
    kernel = bitplane_times(bitplane_work(ctx, 1, a.shape[:-1].numel(), 16 * k, bits.shape[-2], 1),
                            time_ms(torch, lambda: gf256.bitplane_packed(a, bits), 5, rounds=3))
    kernel["plan"] = bitplane_plan_of(a, bits)
    kernel["device_ms_per_launch"] = device_ms_per_launch(
        torch, lambda: gf256.bitplane_packed(a, bits), "bitplane", calls=5)
    kernel.update(_bitplane_sliced(torch, a, bits))
    ctx["bitplane_n16384"] = kernel
    del a, chunk

    torch.cuda.reset_peak_memory_stats()
    ep = BatchedHoneyBadgerEpoch(nets, session_id=b"hb-epoch16384", compact=True,
                                 device="cuda", encrypt_backend="device")
    if ep.acs.rbc.coder is not coder:
        raise AssertionError("the N = 16384 epoch did not take the coder built here")
    keep = {}
    res, ctx["launches_n16384"] = _scale_epochs(
        "N = 16384", ep, nets, contribs, 1, range(2, 3), None, large_epoch_launches(n),
        keep=keep)
    peak = torch.cuda.max_memory_allocated()

    # the parity spot-check: the first proposer chunk of the warm run's
    # framed ciphertexts through stage A, three proposers' shards against
    # the host encoder
    rbc = ep.acs.rbc
    check = [0, 33, 63]
    framed = rbc.upload_framed(keep.pop("payloads")[:64], dev)
    shards = rbc.large_stage_a(framed, None, None, 64)[0][check].cpu().numpy()
    host = framed[check].cpu().numpy()
    del framed
    for i, p in enumerate(check):
        if not np.array_equal(shards[i], coder.encode_np(host[i])):
            raise AssertionError(f"N = 16384: proposer {p}'s shards differ from encode_np")
    return {
        "n": n, "f": f, "k": k, "contribution_bytes": CONTRIB_BYTES_16384, "compact": True,
        "keygen_s": keygen_s, "coder_host_s": coder_host_s, "coder_device_s": coder_device_s,
        "coder_device_mem": coder_mem, "bitplane_chunk": kernel, **res,
        "shards_match_encode_np": check, "peak_mem_bytes": peak,
    }


BITPLANE_SLICE_COLS = 16384


def _bitplane_sliced(torch, a, m) -> dict:
    """The kernel's product of ``a`` against a matrix too large to unpack
    whole (N = 16384: 15.3 GB of int8 bits, 61 GB of float32), held against
    the plain version and timed beside it and ``torch._int_mm`` of the int8
    bits in slices of BITPLANE_SLICE_COLS columns: the plain and library
    times are the slices' times summed (each slice's operands unpacked
    outside its timing)."""
    from hbbft_tpu_torch.ops import gf256

    got = gf256.bitplane_packed(a, m)
    rows, words, cols = a.shape[:-1].numel(), a.shape[-1], m.shape[-2]
    bits8 = gf256.unpack_bits(a, 32 * words).reshape(rows, -1).contiguous()
    plain_ms = int_mm_ms = 0.0
    for c0 in range(0, cols, BITPLANE_SLICE_COLS):
        c1 = min(cols, c0 + BITPLANE_SLICE_COLS)
        part = m[c0:c1]
        ref = gf256.bitplane_packed_plain(a, part)
        if not torch.equal(ref, got[..., c0 // 8:c1 // 8]):
            raise AssertionError(f"bitplane kernel differs from its plain version at "
                                 f"columns {c0} … {c1 - 1}")
        del ref
        plain_ms += time_ms(torch, lambda: gf256.bitplane_packed_plain(a, part), 1, rounds=3)
        torch.cuda.empty_cache()
        mat8 = gf256.unpack_bits(part, 32 * words).reshape(c1 - c0, -1).t()
        int_mm_ms += time_ms(torch, lambda: torch._int_mm(bits8, mat8) & 1, 1, rounds=3)
        del mat8
        torch.cuda.empty_cache()
    return {"max_abs_err": 0, "plain_ms": plain_ms, "library_ms": int_mm_ms,
            "library_int_mm": {"ms": int_mm_ms, "slices": -(-cols // BITPLANE_SLICE_COLS),
                               "slice_cols": BITPLANE_SLICE_COLS}}


def phase_sustained4096(ctx):
    """A sustained N = 4096 session (bench.py's ``sustained4096``): the
    encrypt route calibrated (one warm encrypt phase timed a route, the
    faster kept), then SUSTAINED_EPOCHS epochs with epoch e+1's encrypt on a
    one-worker thread pool while epoch e's ACS and decrypt run; every batch
    equal to the contributions, every instance accepted, the launches of
    the whole session as the code implies."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    nets, contribs, _ = _net4096(ctx)
    torch.cuda.reset_peak_memory_stats()
    hb = BatchedHoneyBadgerEpoch(nets, session_id=b"sustained4096", compact=True, device="cuda")
    calib = {}
    for route in ("native", "device"):
        hb.encrypt_backend = route
        hb.encrypt_phase(contribs, random.Random(7))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hb.encrypt_phase(contribs, random.Random(7))
        torch.cuda.synchronize()
        calib[route] = time.perf_counter() - t0
    route = min(calib, key=calib.get)
    hb.encrypt_backend = route

    enc_times = []

    def encrypt_timed(seed):
        t0 = time.perf_counter()
        out = hb.encrypt_phase(contribs, random.Random(seed))
        enc_times.append(time.perf_counter() - t0)
        return out

    times, phases = [], []
    torch.cuda.synchronize()
    _build.reset_launches()
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(encrypt_timed, 100)
        for e in range(SUSTAINED_EPOCHS):
            t0 = time.perf_counter()
            payloads = fut.result()
            if e + 1 < SUSTAINED_EPOCHS:
                fut = pool.submit(encrypt_timed, 100 + e + 1)
            batch, detail = hb.run_from_payloads(payloads, session_suffix=b"/e%d" % e,
                                                 timer=time.perf_counter)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if batch != contribs:
                raise AssertionError(f"sustained epoch {e} did not return every contribution")
            if not _all_accepted(detail):
                raise AssertionError(f"sustained epoch {e}: a node did not accept every instance")
            phases.append(detail["phase_s"])
    launches = dict(_build.LAUNCHES)
    per_epoch = large_epoch_launches(N_4096)
    if route == "native":
        per_epoch.update(ladder_launches(0))
    check_launches(launches, {k: v * SUSTAINED_EPOCHS for k, v in per_epoch.items()},
                   "sustained N = 4096 session")
    ctx["launches_sustained4096"] = launches
    warm = times[1:] or times
    median_warm = statistics.median(warm)
    return {
        "n": N_4096, "f": F_4096, "contribution_bytes": CONTRIB_BYTES_4096, "compact": True,
        "epochs": len(times), "epochs_baseline": 100, "pipelined": True,
        "epochs_per_s": 1 / median_warm, "t_first_s": times[0], "t_median_warm_s": median_warm,
        "t_min_s": min(times), "t_max_s": max(times),
        "drift_pct": 100 * (warm[-1] - warm[0]) / warm[0] if len(warm) > 1 else 0.0,
        "t_encrypt_median_s": statistics.median(enc_times), "t_encrypt_s": enc_times,
        "encrypt_backend": route, "encrypt_calibration_s": calib,
        "epoch_s": times, "phase_s": phases, "launches": launches, "batch_ok": True,
        "all_accepted": True, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }


# the windowed kernel's cases: (rows, timed) — the N = 64 epoch's and
# coin256's shapes, a ragged count, the encrypt shapes of the N = 1024 and
# N = 4096 epochs (both encrypt in chunks of DEVICE_ENCRYPT_CHUNK = 1 024
# proposers: G1 4 096, G2 2 048 rows a chunk), dkg256's forced device route
# (its 7 396 GLV-split muls padded to 8 192, doubled by the split: 16 384
# rows), G2 8 192 rows, one N = 4096 encrypt in a single chunk, and G1 16
# rows, objsim's share-set fold (8 shares, doubled by the GLV split)
WINDOW_CASES = {"g1": ((256, True), (37, False), (4 * N_LARGE, True), (16384, True),
                       (16, True)),
                "g2": ((128, True), (256, True), (37, False), (2 * N_LARGE, True),
                       (2 * N_4096, True))}
DKG_T = 85
COIN_N, COIN_F = 256, 85


def _window_rows(group: str, rows: int, rng, distinct: int = 2048):
    """``_ladder_rows``' edge rows (a zero scalar, all-ones bits, base_inf
    padding) with at most ``distinct`` distinct points, repeated beyond,
    and a fresh scalar on every row."""
    pts, scalars = _ladder_rows(group, min(rows, distinct), rng)
    if rows > distinct:
        finite = [p for p in pts if p is not None]
        pts = pts[:2] + [finite[i % len(finite)] for i in range(rows - distinct)] + pts[2:]
        scalars = scalars + [rng.getrandbits(128) for _ in range(rows - distinct)]
    return pts, scalars


def _window_slice(group: str, t, off: int, rows: int, total: int):
    """Rows ``off … off + rows`` of a ladder tensor over ``total`` rows: G1
    tensors hold a column a row, G2 ones [re | im] halves of ``total``."""
    if group == "g1":
        return t[..., off: off + rows]
    import torch

    return torch.cat((t[..., off: off + rows], t[..., total + off: total + off + rows]), dim=-1)


def phase_kernel_ladder_window(ctx):
    """The windowed kernel against its plain version on the card, digit-
    and inf-exact, G1 and G2, at each case of ``WINDOW_CASES``, three rows
    of each against the native oracle; the timed cases by CUDA events and
    the profiler, against their bound.  The plain ladder is a loop of
    small launches whose time hardly grows with the rows, so a group's
    first case (the N = 64 epoch's shape) has a plain call of its own,
    timed, and the group's other cases one plain call over all their rows
    together, each case's rows held against their slice of it."""
    import torch

    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.native import get_oracle
    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import gcurve as G
    from hbbft_tpu_torch.ops import ladder_lazy

    dev = torch.device("cuda")
    nat = get_oracle()
    rng = random.Random(6)
    out_groups = {}
    max_err = 0
    for group, cases in WINDOW_CASES.items():
        if group == "g1":
            ops, to_dev, from_dev = G.LAZY_FP_OPS, G.g1_to_device, G.g1_from_device_batch
            to_bytes, oracle_mul = c.g1_to_bytes, nat.bls_g1_mul
        else:
            ops, to_dev, from_dev = G.LAZY_FP2_OPS, G.g2_to_device, G.g2_from_device_batch
            to_bytes, oracle_mul = c.g2_to_bytes, nat.bls_g2_mul
        inputs = [_window_rows(group, rows, rng) for rows, _ in cases]

        def plain(pts, scalars):
            """The plain ladder over these rows, and its ms."""
            pt = to_dev(pts, dev)
            bits = torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev)
            base_inf = torch.tensor([p is None for p in pts], device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
            torch.cuda.synchronize()
            return ref, (time.perf_counter() - t0) * 1e3

        # the first case alone, then the rest as one batch
        refs = {0: (*plain(*inputs[0]), 0, cases[0][0])}
        rest_pts = [p for pts, _ in inputs[1:] for p in pts]
        rest_scalars = [s for _, scalars in inputs[1:] for s in scalars]
        rest_ref, rest_ms = plain(rest_pts, rest_scalars)
        off = 0
        for i, (rows, _) in enumerate(cases[1:], start=1):
            refs[i] = (rest_ref, None, off, len(rest_pts))
            off += rows
        shapes = {}
        for i, ((rows, timed), (pts, scalars)) in enumerate(zip(cases, inputs)):
            pt = to_dev(pts, dev)
            bits = torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev)
            base_inf = torch.tensor([p is None for p in pts], device=dev)
            out, inf = G.scalar_mul_lazy_window(ops, pt, bits, base_inf)
            (ref, ref_inf), plain_ms, off, total = refs[i]
            ref = [_window_slice(group, r, off, rows, total) for r in ref]
            ref_inf = ref_inf[off: off + rows]
            torch.cuda.synchronize()
            err = max(int((g.long() - r.long()).abs().max()) for g, r in zip(out, ref))
            max_err = max(max_err, err)
            if err or not torch.equal(inf, ref_inf):
                raise AssertionError(f"{group} window kernel differs from its plain version "
                                     f"at R={rows}")
            inf_h = inf.cpu().tolist()
            if inf_h != [s == 0 or p is None for p, s in zip(pts, scalars)]:
                raise AssertionError(f"{group} window kernel: wrong infinity rows at R={rows}")
            host = from_dev(out)
            for r in (0, 1, 2):
                got = to_bytes(None if inf_h[r] else host[r])
                want = (to_bytes(None) if pts[r] is None
                        else oracle_mul(to_bytes(pts[r]), scalars[r]))
                if got != want:
                    raise AssertionError(f"{group} window kernel differs from the native "
                                         f"oracle, row {r} of {rows}")
            k = ladder_lazy.window_k(rows, group == "g2")
            shape = {"rows": rows, "bits": LADDER_BITS, "plain_ms": plain_ms,
                     "inf_rows": sum(inf_h), "k": k,
                     **ladder_lazy.window_info(k, group == "g2"),
                     "sass_per_op": ctx["field_sass"][k]}
            if plain_ms is None:
                shape["plain_checked_in"] = {"rows": len(rest_pts), "ms": rest_ms}
            if timed:
                def run():
                    return G.scalar_mul_lazy_window(ops, pt, bits, base_inf)

                recorded = {}
                dev_ms = device_ms_per_launch(torch, run, "ladder_window_kernel", calls=5,
                                              detail=recorded)
                ev_ms = event_ms_per_launch(torch, run)
                n_bytes = ladder_bytes(rows, out[0].shape[1], LADDER_BITS)
                n_ops = ladder_window_ops(group, rows, LADDER_BITS)
                bms, by = bound_ms(ctx, n_bytes, n_ops)
                # the split of the time over the bound: the field's warp
                # instructions against the bound's (its lane instructions
                # over 32), and the share of the schedulers' issue slots
                # (4 an SM a clock) they fill in the time measured
                issued = window_warp_instructions(group, rows, LADDER_BITS, k,
                                                  ctx["field_sass"][k])
                slots = ev_ms * 1e-3 * ctx["sm_clocks_per_s"] * 4
                shape.update({
                    "ms": time_ms(torch, run, 3, rounds=3), "device_ms_per_launch": dev_ms,
                    "profiler": recorded, "event_ms_per_launch": ev_ms,
                    "bound_ms": bms, "bound_by": by, "share_of_bound": bms / ev_ms,
                    "bytes": n_bytes, "ops": n_ops, "field_warp_instructions": issued,
                    "instructions_over_bound": issued * 32 / sum(n_ops),
                    "issue_share": issued / slots})
            shapes[rows] = shape
        out_groups[group] = shapes
    ctx["window"] = {"max_abs_err": max_err, **out_groups}
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "inf_exact": True,
            "by_group": {g: {str(r): v for r, v in d.items()} for g, d in out_groups.items()}}


CROSSOVER_ROWS = (128, 256, 512, 1024, 2048, 4096, 16384, 65536)


def phase_ladder_crossover(ctx):
    """Both ladder kernels at every row count of ``CROSSOVER_ROWS``, G1 and
    G2, 132 bits: ms of one launch by CUDA events (``event_ms_per_launch``),
    the windowed kernel at each K (rows a block) beside the K it picks, and
    the largest row count up to which the windowed kernel is the faster.
    It fails below the largest count (every dispatch of ``crypto/batch.py``
    runs the windowed kernel), or where two K's results differ."""
    import torch

    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import gcurve as G
    from hbbft_tpu_torch.ops import ladder_lazy

    dev = torch.device("cuda")
    rng = random.Random(7)
    table = {}
    for group in ("g1", "g2"):
        fp2 = group == "g2"
        ops, to_dev = ((G.LAZY_FP2_OPS, G.g2_to_device) if fp2
                       else (G.LAZY_FP_OPS, G.g1_to_device))
        pool, _ = _ladder_rows(group, 256, rng)
        pool = [p for p in pool if p is not None]
        rows_out = []
        for rows in CROSSOVER_ROWS:
            pts = [pool[i % len(pool)] for i in range(rows)]
            pt = to_dev(pts, dev)
            bits = torch.from_numpy(F.bits_batch([rng.getrandbits(128) for _ in pts],
                                                 LADDER_BITS)).to(dev)
            base_inf = torch.zeros(rows, dtype=torch.bool, device=dev)
            row = {"rows": rows, "k": ladder_lazy.window_k(rows, fp2)}
            for name, fn in (("window", G.scalar_mul_lazy_window), ("bitwise", G.scalar_mul_lazy)):
                row[f"{name}_ms"] = event_ms_per_launch(
                    torch, lambda: fn(ops, pt, bits, base_inf), calls=3)
            want = G.scalar_mul_lazy_window(ops, pt, bits, base_inf)
            for k in ladder_lazy.KS:
                def run_k():
                    return ladder_lazy.ladder_window_k(pt, bits, base_inf, fp2, k)

                got = run_k()
                if not (all(torch.equal(x, y) for x, y in zip(got[0], want[0]))
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{group} window kernel at K = {k} differs from "
                                         f"K = {row['k']} at {rows} rows")
                row[f"window_k{k}_ms"] = event_ms_per_launch(torch, run_k, calls=3)
            row["ratio"] = row["window_ms"] / row["bitwise_ms"]
            rows_out.append(row)
        table[group] = rows_out
    faster = {g: [r["rows"] for r in t if r["ratio"] < 1] for g, t in table.items()}
    # the largest count up to which the window kernel wins in both groups
    upto = 0
    for rows in CROSSOVER_ROWS:
        if all(rows in f for f in faster.values()):
            upto = rows
        else:
            break
    if upto < CROSSOVER_ROWS[-1]:
        raise AssertionError(f"the bitwise ladder is the faster above {upto} rows: "
                             f"{table}")
    return {"by_group": table, "window_faster_up_to_rows": upto,
            "window_info": {g: {k: ladder_lazy.window_info(k, g == "g2") for k in ladder_lazy.KS}
                            for g in ("g1", "g2")},
            "smi": ctx["smi"]}


# The 8-bit field's windowed kernel (csrc/ladder_mxu.cu): its rows on the
# paths the reference sends to that field (ladders of at most 2 048 rows):
# G1 16 (a share-set fold), G1 256 and G2 128 (the N = 64 encrypt), G2 256
# (coin256).  Its work for the bound: each product's convolution (49 × 49)
# and fold (51 × 49) multiply-adds on the tensor cores at the f16 dense rate,
# and the field's int32 instructions as FP_KIND_OPS counts them for the
# 13-bit field: a rough carry pass 2 ALU instructions a digit; the squeeze 3
# passes over 52 digits, then 3 rounds of 3 × 49 multiply-adds and 3
# passes; a product 3 passes over 100 digits, 49 adds (the fold into the low
# digits) and the squeeze; a sum or difference 49 (three-input) adds and the
# squeeze; a select 49.
MXU_CASES = {"g1": (16, 4 * N_NODES), "g2": (2 * N_NODES, COIN_N)}
MXU_RAGGED = (("g1", 37, 8), ("g2", 5, 20))  # (group, rows, bits), held exact, not timed
MXU_SWEEP_ROWS = (16, 64, 256, 1024, 2048, 8192)  # against ladder_window, each K timed
MXU_SWEEP_POINTS = 64  # distinct points of the sweep's rows (every row its own scalar)
F16_DENSE_FLOPS = 989e12  # H100 SXM data sheet, dense
MXU_NL = 49
MXU_MUL_MACS = MXU_NL * MXU_NL + 51 * MXU_NL
MXU_SQUEEZE_OPS = (12 * 52 * CARRY_OPS, 3 * 3 * MXU_NL, 0)
MXU_FP_KIND_OPS = {
    "MUL": (3 * 100 * CARRY_OPS + MXU_SQUEEZE_OPS[0], MXU_SQUEEZE_OPS[1], MXU_NL),
    "ADD": (MXU_SQUEEZE_OPS[0], MXU_SQUEEZE_OPS[1], MXU_NL),
    "SUB": (MXU_SQUEEZE_OPS[0], MXU_SQUEEZE_OPS[1], MXU_NL),
    "SEL": (0, 0, MXU_NL),
}


class _FieldOpCount:
    """An ops table that counts a point formula's field operations."""

    def __init__(self):
        self.n = {"mul": 0, "sqr": 0, "add": 0, "sub": 0}

    def _op(kind):
        def op(self, *args):
            self.n[kind] += 1
            return 0
        return op

    mul, sqr, add, sub = _op("mul"), _op("sqr"), _op("add"), _op("sub")


def mxu_ladder_work(group: str, rows: int, nbits: int):
    """(tensor-core multiply-adds, int32 (ALU, multiply-add, either)) of
    the 8-bit field's windowed ladder: the table (7 doublings, 7
    additions), per window 4 doublings, one addition and 3 point selects;
    an Fp2 product is 3 Fp products, 3 sums and 2 differences, a square 2,
    2 and 1, an Fp2 sum or difference 2 of Fp, a select 2."""
    from hbbft_tpu_torch.ops import gcurve as G

    def count(formula, *pts):
        o = _FieldOpCount()
        formula(o, *pts)
        return o.n

    dbl = count(G.point_double, (0, 0, 0))
    add = count(G.point_add_raw, (0, 0, 0), (0, 0, 0))
    windows = nbits // 4
    n = {k: 7 * (dbl[k] + add[k]) + windows * (4 * dbl[k] + add[k]) for k in dbl}
    sel = 9 * windows
    if group == "g2":
        fp = {"MUL": 3 * n["mul"] + 2 * n["sqr"],
              "ADD": 3 * n["mul"] + 2 * n["sqr"] + 2 * n["add"],
              "SUB": 2 * n["mul"] + n["sqr"] + 2 * n["sub"], "SEL": 2 * sel}
    else:
        fp = {"MUL": n["mul"] + n["sqr"], "ADD": n["add"], "SUB": n["sub"], "SEL": sel}
    ops = ops_sum([tuple(fp[k] * x for x in MXU_FP_KIND_OPS[k]) for k in fp], rows)
    return fp["MUL"] * MXU_MUL_MACS * rows, ops


def mxu_bound_ms(ctx, n_bytes: float, macs: int, ops):
    """The larger of ``bound_ms`` (bytes, int32 pipes) and the tensor-core
    multiply-adds at the f16 dense rate."""
    ms, by = bound_ms(ctx, n_bytes, ops)
    tc_ms = 2 * macs / F16_DENSE_FLOPS * 1e3
    return (tc_ms, "operations") if tc_ms > ms else (ms, by)


@contextlib.contextmanager
def _field_backend(value: str):
    before = os.environ.get("HBBFT_FIELD_BACKEND")
    os.environ["HBBFT_FIELD_BACKEND"] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ["HBBFT_FIELD_BACKEND"]
        else:
            os.environ["HBBFT_FIELD_BACKEND"] = before


def _mxu_plain_check(torch, group: str, ops, inputs, operands):
    """One plain ladder (``ops``: the 8-bit field) over the rows of every
    ``(points, scalars)`` of ``inputs``; returns ``check(got, inf, i,
    rows, what)``, which holds a kernel's result for input ``i`` against
    its slice of that call and returns the largest digit difference (0),
    the plain call's ms and its rows."""
    import numpy as np

    from hbbft_tpu_torch.ops import fp381_mxu as M
    from hbbft_tpu_torch.ops import gcurve as G

    all_pts = [p for pts, _ in inputs for p in pts]
    pt, bits, base_inf = operands(all_pts, [s for _, sc in inputs for s in sc], M)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref, ref_inf = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    offsets = np.cumsum([0] + [len(p) for p, _ in inputs])

    def check(got, inf, i, rows, what):
        off = int(offsets[i])
        want = [_window_slice(group, r, off, rows, len(all_pts)) for r in ref]
        torch.cuda.synchronize()
        err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
        if err or not torch.equal(inf, ref_inf[off: off + rows]):
            raise AssertionError(f"{group} ladder_mxu differs from its plain version "
                                 f"at R={rows} ({what})")
        return err

    return check, plain_ms, len(all_pts)


def phase_kernel_ladder_mxu(ctx):
    """The 8-bit field's windowed kernel (``csrc/ladder_mxu.cu``) against
    its plain version on the card, digit- and inf-exact, at each case of
    ``MXU_CASES`` (one plain call a group over all its cases), with
    ``_window_rows``' edge rows and three rows against the native oracle,
    and at the ragged ``MXU_RAGGED`` cases; each case timed by CUDA events
    and the profiler against its bound, and ``ladder_window`` at the same
    rows.  Then, under ``HBBFT_FIELD_BACKEND=mxu``, one N = 64 epoch (its
    ciphertexts equal to the native oracle's, every contribution back,
    every instance accepted) and one coin256 verify (True; False with a
    forged share), each with its ladders all ``ladder_mxu`` launches.  Last
    the sweep: each row count of ``MXU_SWEEP_ROWS`` (one plain call a group
    over all of them) held exact, timed at every K (every K's result
    equal) and beside ``ladder_window`` (the crossover)."""
    import numpy as np
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.native import get_oracle
    from hbbft_tpu_torch.ops import fp381 as F
    from hbbft_tpu_torch.ops import fp381_mxu as M
    from hbbft_tpu_torch.ops import gcurve as G
    from hbbft_tpu_torch.ops import ladder_lazy, ladder_mxu

    dev = torch.device("cuda")
    nat = get_oracle()
    rng = random.Random(17)
    out_groups, sweep, max_err = {}, {}, 0
    for group, cases in MXU_CASES.items():
        fp2 = group == "g2"
        ops, lazy_ops = ((G.MXU_FP2_OPS, G.LAZY_FP2_OPS) if fp2
                         else (G.MXU_FP_OPS, G.LAZY_FP_OPS))
        to_dev, from_dev = ((G.g2_to_device, G.g2_from_device_batch) if fp2
                            else (G.g1_to_device, G.g1_from_device_batch))
        to_bytes, oracle_mul = ((c.g2_to_bytes, nat.bls_g2_mul) if fp2
                                else (c.g1_to_bytes, nat.bls_g1_mul))
        inputs = [_window_rows(group, rows, rng) for rows in cases]

        def operands(pts, scalars, rep):
            return (to_dev(pts, dev, rep=rep),
                    torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev),
                    torch.tensor([p is None for p in pts], device=dev))

        check, plain_ms, plain_rows = _mxu_plain_check(torch, group, ops, inputs, operands)
        shapes = {}
        for i, (rows, (pts, scalars)) in enumerate(zip(cases, inputs)):
            pt, bits, base_inf = operands(pts, scalars, M)

            def run():
                return G.scalar_mul_lazy_window(ops, pt, bits, base_inf)

            got, inf = run()
            max_err = max(max_err, check(got, inf, i, rows, "a case"))
            inf_h = inf.cpu().tolist()
            if inf_h != [s == 0 or p is None for p, s in zip(pts, scalars)]:
                raise AssertionError(f"{group} ladder_mxu: wrong infinity rows at R={rows}")
            host = from_dev(got, rep=M)
            for r in (0, 1, 2):
                have = to_bytes(None if inf_h[r] else host[r])
                need = (to_bytes(None) if pts[r] is None
                        else oracle_mul(to_bytes(pts[r]), scalars[r]))
                if have != need:
                    raise AssertionError(f"{group} ladder_mxu differs from the native oracle, "
                                         f"row {r} of {rows}")
            recorded = {}
            dev_ms = device_ms_per_launch(torch, run, "ladder_mxu_kernel", calls=5,
                                          detail=recorded)
            ev_ms = event_ms_per_launch(torch, run)
            pt13, bits13, inf13 = operands(pts, scalars, F)
            window_ms = event_ms_per_launch(
                torch, lambda: G.scalar_mul_lazy_window(lazy_ops, pt13, bits13, inf13))
            n_bytes = 2 * 3 * MXU_NL * got[0].shape[1] * 4 + rows * LADDER_BITS * 4 + 2 * rows
            macs, n_ops = mxu_ladder_work(group, rows, LADDER_BITS)
            bms, by = mxu_bound_ms(ctx, n_bytes, macs, n_ops)
            k = ladder_mxu.mxu_k(rows, fp2)
            shapes[rows] = {
                "rows": rows, "bits": LADDER_BITS, "inf_rows": sum(inf_h),
                "ms": ev_ms, "event_ms_per_launch": ev_ms, "device_ms_per_launch": dev_ms,
                "profiler": recorded, "bound_ms": bms, "bound_by": by,
                "share_of_bound": bms / ev_ms, "bytes": n_bytes, "tensor_macs": macs,
                "int32_ops": n_ops, "ladder_window_ms": window_ms,
                "mxu_over_window": ev_ms / window_ms, "k": k, **ladder_mxu.info(fp2, k),
                "ladder_window_k": ladder_lazy.window_k(rows, fp2)}
        out_groups[group] = {"plain_ms": plain_ms, "plain_rows": plain_rows,
                             "info": {k: ladder_mxu.info(fp2, k) for k in ladder_mxu.KS},
                             "shapes": shapes}
    for group, rows, nbits in MXU_RAGGED:
        ops = G.MXU_FP2_OPS if group == "g2" else G.MXU_FP_OPS
        pts, _ = _ladder_rows(group, rows, rng)
        scalars = [rng.getrandbits(nbits) for _ in pts[:-1]] + [0]
        pt = (G.g2_to_device if group == "g2" else G.g1_to_device)(pts, dev, rep=M)
        bits = torch.from_numpy(F.bits_batch(scalars, nbits)).to(dev)
        base_inf = torch.tensor([p is None for p in pts], device=dev)
        got, inf = G.scalar_mul_lazy_window(ops, pt, bits, base_inf)
        want, want_inf = G.scalar_mul_lazy_window_plain(ops, pt, bits, base_inf)
        torch.cuda.synchronize()
        if not (all(torch.equal(g, w) for g, w in zip(got, want)) and torch.equal(inf, want_inf)):
            raise AssertionError(f"{group} ladder_mxu differs from its plain version at "
                                 f"R={rows}, {nbits} bits")

    # the reference's route to the 8-bit field, forced on the paths
    if "epoch" in ctx:
        ep, _, contribs = ctx["epoch"]
        nets = ep.netinfo_map
    else:
        from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

        nets, contribs = _epoch64_inputs()
        ep = BatchedHoneyBadgerEpoch(nets, device="cuda", encrypt_backend="device")
    pk = nets[0].public_key_set().public_key()
    native = [ct.to_bytes() for ct in tc.tpke_encrypt_batch(
        pk, [contribs[i] for i in ep.ids], random.Random(13), backend="native", device="cpu")]
    n_ladders = encrypt_ladder_launches(N_NODES)["ladder_window"]
    sks = tc.SecretKeySet.random(COIN_F, random.Random(98))
    pks = sks.public_keys()
    msg = b"coin-epoch-mxu"
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(msg)) for i in range(COIN_N)]
    forged = list(pairs)
    forged[5] = (pairs[5][0], sks.secret_key_share(5).sign(b"coin-epoch-other"))
    with _field_backend("mxu"):
        torch.cuda.synchronize()
        _build.reset_launches()
        payloads = ep.encrypt_phase(contribs, random.Random(13))
        torch.cuda.synchronize()
        encrypt_launches = dict(_build.LAUNCHES)
        if payloads != native:
            raise AssertionError("mxu: the device-route ciphertexts differ from the native "
                                 "oracle's")
        check_launches({k: encrypt_launches[k] for k in LADDER_KERNELS},
                       ladder_launches(n_ladders, "ladder_mxu"), "mxu encrypt")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        batch, detail = ep.run(contribs, random.Random(14), timer=time.perf_counter)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0
        epoch_launches_mxu = dict(_build.LAUNCHES)
        if batch != contribs or not np.asarray(detail["accepted"]).all():
            raise AssertionError("mxu: the N = 64 epoch did not return every contribution")
        check_launches(epoch_launches_mxu,
                       {**epoch_launches(N_NODES), **ladder_launches(n_ladders, "ladder_mxu")},
                       "mxu epoch")
        crng = random.Random(15)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        coin_ok = B.batch_verify_sig_shares(pairs, msg, crng)
        coin_s = time.perf_counter() - t0
        coin_launches = {k: _build.LAUNCHES[k] for k in LADDER_KERNELS}
        if coin_ok is not True or B.batch_verify_sig_shares(forged, msg, crng) is not False:
            raise AssertionError("mxu: coin256's verify is wrong")
        check_launches(coin_launches, ladder_launches(2, "ladder_mxu"), "mxu coin256")
    # the sweep, last (its batches run after the route's epoch, as the
    # parent's phase runs that epoch): the kernel at every K (the same
    # result) and at the K it picks, beside ladder_window at its own; one
    # plain call a group over all its rows
    for group in MXU_CASES:
        fp2 = group == "g2"
        ops, lazy_ops = ((G.MXU_FP2_OPS, G.LAZY_FP2_OPS) if fp2
                         else (G.MXU_FP_OPS, G.LAZY_FP_OPS))
        to_dev = G.g2_to_device if fp2 else G.g1_to_device
        pool = [p for p in _ladder_rows(group, MXU_SWEEP_POINTS, rng)[0] if p is not None]
        sweep_inputs = [([pool[i % len(pool)] for i in range(rows)],
                         [rng.getrandbits(128) for _ in range(rows)]) for rows in MXU_SWEEP_ROWS]

        def operands(pts, scalars, rep):
            return (to_dev(pts, dev, rep=rep),
                    torch.from_numpy(F.bits_batch(scalars, LADDER_BITS)).to(dev),
                    torch.tensor([p is None for p in pts], device=dev))

        check, plain_ms, plain_rows = _mxu_plain_check(torch, group, ops, sweep_inputs, operands)
        rows_out = []
        for i, (rows, (pts, scalars)) in enumerate(zip(MXU_SWEEP_ROWS, sweep_inputs)):
            pt, bits, base_inf = operands(pts, scalars, M)
            got, inf = G.scalar_mul_lazy_window(ops, pt, bits, base_inf)
            max_err = max(max_err, check(got, inf, i, rows, "the sweep"))
            row = {"rows": rows, "k": ladder_mxu.mxu_k(rows, fp2)}
            for k in ladder_mxu.KS:
                def run_k():
                    return ladder_mxu.ladder_mxu_k(pt, bits, base_inf, fp2, k)

                got_k, inf_k = run_k()
                if not (all(torch.equal(x, y) for x, y in zip(got_k, got))
                        and torch.equal(inf_k, inf)):
                    raise AssertionError(f"{group} ladder_mxu at K = {k} differs from K = "
                                         f"{row['k']} at {rows} rows")
                row[f"mxu_k{k}_ms"] = event_ms_per_launch(torch, run_k, calls=3)
            row["mxu_ms"] = row[f"mxu_k{row['k']}_ms"]
            pt13 = to_dev(pts, dev)
            row["window_k"] = ladder_lazy.window_k(rows, fp2)
            row["window_ms"] = event_ms_per_launch(
                torch, lambda: G.scalar_mul_lazy_window(lazy_ops, pt13, bits, base_inf), calls=3)
            row["mxu_over_window"] = row["mxu_ms"] / row["window_ms"]
            rows_out.append(row)
        sweep[group] = {"rows": rows_out, "plain_ms": plain_ms, "plain_rows": plain_rows,
                        "mxu_faster_at_rows": [r["rows"] for r in rows_out
                                               if r["mxu_over_window"] < 1],
                        "best_k_by_rows": {r["rows"]: min(ladder_mxu.KS,
                                                          key=lambda k: r[f"mxu_k{k}_ms"])
                                           for r in rows_out}}
    ctx["mxu"] = {"max_abs_err": max_err, **out_groups, "sweep": sweep}
    ctx["mxu_launches"] = {"epoch": epoch_launches_mxu["ladder_mxu"],
                           "coin256": coin_launches["ladder_mxu"]}
    return {"max_abs_err": max_err, "tolerance": 0, "digit_exact": True, "inf_exact": True,
            "by_group": {g: {**v, "shapes": {str(r): x for r, x in v["shapes"].items()}}
                         for g, v in out_groups.items()},
            "sweep": sweep,
            "epoch64": {"field_backend": "mxu", "ciphertexts_match_native": True,
                        "batch_ok": True, "epoch_s": epoch_s, "phase_s": detail["phase_s"],
                        "launches": epoch_launches_mxu},
            "coin256": {"field_backend": "mxu", "valid": True, "forged_share_rejected": True,
                        "verify_s": coin_s, "launches": coin_launches},
            "field_backend_after": os.environ.get("HBBFT_FIELD_BACKEND"),
            "smi": ctx["smi"]}


def _ladder_launch_counts():
    from hbbft_tpu_torch import _build

    return {k: _build.LAUNCHES[k] for k in LADDER_KERNELS}


def phase_coin256(ctx):
    """BASELINE config 3, the common coin at N = 256, f = 85:
    ``batch_verify_sig_shares`` over 256 (PublicKeyShare, SignatureShare)
    pairs as bench.py's ``_coin256_setup`` makes them; False with one share
    signed over another message; the MSMs against the host's sums; and
    ``batch_verify_dec_shares`` over 256 decryption shares of a ciphertext,
    valid and with one tampered."""
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.crypto import tc

    t0 = time.perf_counter()
    rng = random.Random(99)
    sks = tc.SecretKeySet.random(COIN_F, rng)
    pks = sks.public_keys()
    msg = b"coin-epoch-42"
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(msg))
             for i in range(COIN_N)]
    setup_s = time.perf_counter() - t0

    if B.batch_verify_sig_shares(pairs, msg, rng) is not True:  # warm
        raise AssertionError("coin256: the valid shares did not verify")
    times, launches = [], None
    for _ in range(3):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        ok = B.batch_verify_sig_shares(pairs, msg, rng)
        times.append(time.perf_counter() - t0)
        launches = _ladder_launch_counts()
        if ok is not True:
            raise AssertionError("coin256: the valid shares did not verify")
    want_launches = ladder_launches(2)
    if launches != want_launches:
        raise AssertionError(f"coin256 launches {launches}, expected {want_launches}")

    # the verify's split, step by step as batch_verify_sig_shares runs it
    cc = B.cache_for("cuda")
    rs = [rng.getrandbits(128) | 1 for _ in pairs]
    torch.cuda.synchronize()
    s0 = time.perf_counter()
    h_sig = cc._msm_dispatch("g2", [sg.point for _, sg in pairs], rs)
    h_pk = cc._msm_dispatch("g1", [pk.point for pk, _ in pairs], rs)
    s1 = time.perf_counter()
    torch.cuda.synchronize()
    s2 = time.perf_counter()
    sig_comb = cc._msm_collect(h_sig)
    pk_comb = cc._msm_collect(h_pk)
    s3 = time.perf_counter()
    verdict = c.pairing_check([(c.g1_neg(c.G1_GEN), sig_comb), (pk_comb, c.hash_g2(msg))])
    s4 = time.perf_counter()
    if not verdict:
        raise AssertionError("coin256: the split verify failed")
    # the MSMs against the host's Σ rᵢPᵢ for the same randomizers
    want_sig, want_pk = None, None
    for (pk, sg), r in zip(pairs, rs):
        want_sig = c.g2_add(want_sig, c.g2_mul(sg.point, r))
        want_pk = c.g1_add(want_pk, c.g1_mul(pk.point, r))
    if not (c.g2_eq(sig_comb, want_sig) and c.g1_eq(pk_comb, want_pk)):
        raise AssertionError("coin256: the MSMs differ from the host's sums")

    forged, k = list(pairs), COIN_N // 15  # share 17 of 256
    forged[k] = (pairs[k][0], sks.secret_key_share(k).sign(b"coin-epoch-43"))
    if B.batch_verify_sig_shares(forged, msg, rng) is not False:
        raise AssertionError("coin256: a share over another message verified")

    # 256 decryption shares of one ciphertext
    ct = pks.public_key().encrypt(b"coin256 decryption-share payload", rng)
    dpairs = [(pks.public_key_share(i), sks.secret_key_share(i).decrypt_share(ct, check=False))
              for i in range(COIN_N)]
    t0 = time.perf_counter()
    dec_ok = B.batch_verify_dec_shares(dpairs, ct, rng)
    dec_s = time.perf_counter() - t0
    bad, k = list(dpairs), COIN_N * 25 // 32  # share 200 of 256
    bad[k] = (dpairs[k][0], tc.DecryptionShare(c.g1_add(dpairs[k][1].point, c.G1_GEN)))
    if dec_ok is not True or B.batch_verify_dec_shares(bad, ct, rng) is not False:
        raise AssertionError("coin256: the decryption-share batch verify is wrong")

    # the host's per-share verification, sampled (bench.py's denominator)
    t0 = time.perf_counter()
    for pk, sg in pairs[:4]:
        if not pk.verify(sg, msg):
            raise AssertionError("coin256: a host per-share check failed")
    host_s = (time.perf_counter() - t0) / 4 * COIN_N
    median = statistics.median(times)
    ctx["coin256_launches"] = launches
    return {
        "n": COIN_N, "f": COIN_F, "setup_s": setup_s, "verify_s": times,
        "verify_s_median": median, "valid": True, "forged_share_rejected": True,
        "msm_equal_host": True, "ladder_launches_per_verify": launches,
        "split_s": {"dispatch_host": s1 - s0, "ladders_wait": s2 - s1,
                    "fetch_and_host_fold": s3 - s2, "hash_and_pairing_check": s4 - s3},
        "ladders_device_ms": {g: ctx["window"][g][COIN_N]["event_ms_per_launch"]
                              for g in ("g1", "g2")},
        "dec_shares_valid": True, "dec_share_tamper_rejected": True, "dec_verify_s": dec_s,
        "host_per_share_s_x256": host_s, "speedup_vs_host": host_s / median,
    }


def _timed(fn, reps: int = 3, warm: bool = True):
    """(result, median seconds of ``reps`` calls, after one warm call
    unless ``warm`` is False)."""
    out = fn() if warm else None
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, statistics.median(times)


DKG_THRESHOLDS = ("DEVICE_BIVAR_MIN_BATCH", "DEVICE_ROW_MIN_BATCH", "DEVICE_EVAL_MIN_BATCH")
# the routing sweeps of dkg256: ``bivar_commitment`` at small degrees (its
# crossover), ``commitment_row``/``_eval`` above t = 85's 7 396 muls, the
# fold and the share generation by rows, the TPKE encrypt/decrypt at the
# epochs' N with their 64 000-byte contributions
BIVAR_SWEEP_T = (0, 1, 2, 3, 4, 6, 8, 24)
ROW_SWEEP_T = (2, 8, 24, DKG_T)
FOLD_SWEEP = (1, 2, 4, 8, 16, 32, 64, 256, 1024, 4096)
SHARE_GEN_SWEEP = (1, 4, 8, 16, 64, 256, 1024)
TPKE_SWEEP_N = (N_NODES,)
# AUTO encrypt without the native oracle: the per-item Python route
# against the device route, by items
NO_ORACLE_SWEEP = (1, 2, 4, 16, 64)


@contextlib.contextmanager
def _thresholds(B, names, value):
    """``crypto/batch.py``'s routing ``names`` set to ``value`` (1 forces
    the device ladder, a huge value the host) for the block."""
    saved = {n: getattr(B, n) for n in names}
    for n in names:
        setattr(B, n, value)
    try:
        yield
    finally:
        for n, v in saved.items():
            setattr(B, n, v)


HOST = 1 << 40  # a threshold no batch reaches


def _route_pair(B, names, fn, reps: int, warm: bool = True):
    """(host result, host s, device result, device s) of ``fn`` with
    ``names`` forced to each route, each the median of ``reps`` calls (after
    a warm one unless ``warm`` is False)."""
    with _thresholds(B, names, HOST):
        host, host_s = _timed(fn, reps, warm)
    with _thresholds(B, names, 1):
        dev, dev_s = _timed(fn, reps, warm)
    return host, host_s, dev, dev_s


def _crossover(rows, size_key: str):
    """The smallest size from which the device was faster at every larger
    size measured (None: the host won at the largest)."""
    won = None
    for r in sorted(rows, key=lambda r: r[size_key], reverse=True):
        if r["device_s"] < r["host_s"]:
            won = r[size_key]
        else:
            break
    return won


def _tpke_routes(B, tc, n: int, rng):
    """Native against device TPKE encrypt and decrypt of ``n`` 64 000-byte
    messages (bench.py's encrypt calibration: one call each), and the
    decryption-share generation over the same ciphertexts; every route's
    result held equal."""
    sk_set = tc.SecretKeySet.random(1, random.Random(n))
    pks = sk_set.public_keys()
    shares = [(i, sk_set.secret_key_share(i)) for i in range(2)]
    msgs = [rng.randbytes(CONTRIB_BYTES) for _ in range(n)]
    out = {"n": n, "msg_bytes": CONTRIB_BYTES}
    cts = {}
    for backend in ("native", "device"):
        t0 = time.perf_counter()
        cts[backend] = tc.tpke_encrypt_batch(pks.public_key(), msgs, random.Random(n + 1),
                                             backend=backend)
        out[f"encrypt_{backend}_s"] = time.perf_counter() - t0
    if [ct.to_bytes() for ct in cts["native"]] != [ct.to_bytes() for ct in cts["device"]]:
        raise AssertionError(f"TPKE encrypt at n={n}: the device route differs from native")
    out["auto_route"] = "device" if B.device_encrypt_worthwhile(n, "cuda") else "native"
    names = ("DEVICE_DECRYPT_MIN_BATCH",)
    host, out["decrypt_host_s"], dev, out["decrypt_device_s"] = _route_pair(
        B, names, lambda: B.batch_tpke_decrypt(pks, cts["native"], shares), reps=1,
        warm=False)
    if host != msgs or dev != msgs:
        raise AssertionError(f"TPKE decrypt at n={n}: a route lost a plaintext")
    payloads = [ct.to_bytes() for ct in cts["native"]]
    t0 = time.perf_counter()
    if B.batch_tpke_check_decrypt(pks, payloads, shares) != msgs:
        raise AssertionError(f"TPKE check-decrypt at n={n} lost a plaintext")
    out["check_decrypt_s"] = time.perf_counter() - t0
    return out


def _no_oracle_encrypt(tc, c, rng):
    """TPKE encrypt of NO_ORACLE_SWEEP items of 64 000 bytes without the
    native oracle (``bls12_381._native`` reporting none): the per-item
    Python route against the device route, results held equal."""
    pk = tc.SecretKey.random(rng).public_key()
    msgs = [rng.randbytes(CONTRIB_BYTES) for _ in range(max(NO_ORACLE_SWEEP))]
    native = c._native
    c._native = lambda: None
    try:
        rows = []
        for n in NO_ORACLE_SWEEP:
            out = {}
            for backend in ("native", "device"):  # "native" falls back to Python
                t0 = time.perf_counter()
                out[backend] = tc.tpke_encrypt_batch(pk, msgs[:n], random.Random(n),
                                                     backend=backend)
                out[backend + "_s"] = time.perf_counter() - t0
            if [x.to_bytes() for x in out["native"]] != [x.to_bytes() for x in out["device"]]:
                raise AssertionError(f"encrypt without the oracle at n={n}: the routes differ")
            rows.append({"n": n, "host_s": out["native_s"], "device_s": out["device_s"]})
    finally:
        c._native = native
    return rows


def phase_dkg256(ctx):
    """The DKG at N = 256 (t = 85, bench.py's ``_dkg256_commitment``):
    ``commitment_row(com, 3)`` on the production and the forced device
    route, both against ``com.row(3)``; ``commitment_eval`` and
    ``bivar_commitment`` on the forced device route against their host
    values; then the sweeps that ``crypto/batch.py``'s routing thresholds
    are set from, host against device: ``bivar_commitment`` by degree,
    ``commitment_row``/``_eval`` up to t = 85, ``rlc_fold_g1`` and
    ``batch_decrypt_share_gen`` by rows, and TPKE encrypt and decrypt at
    N = 64 — every route's result equal."""
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.crypto import tc

    muls = (DKG_T + 1) ** 2
    poly = tc.BivarPoly.random(DKG_T, random.Random(21))
    t0 = time.perf_counter()
    com = poly.commitment()
    host_commit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    row_host = com.row(3)
    host_row_s = time.perf_counter() - t0

    row_best, best_s = _timed(lambda: B.commitment_row(com, 3))
    best_route = "device" if B._device_worthwhile(muls, B.DEVICE_ROW_MIN_BATCH) else "host-horner"
    with _thresholds(B, DKG_THRESHOLDS, 1):
        _build.reset_launches()
        row_dev = B.commitment_row(com, 3)
        torch.cuda.synchronize()
        launches = _ladder_launch_counts()
        row_dev, dev_row_s = _timed(lambda: B.commitment_row(com, 3))
        t0 = time.perf_counter()
        ev_dev = B.commitment_eval(com, 3, 6)
        dev_eval_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        com_dev = B.bivar_commitment(poly)
        dev_commit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ev_host = com.evaluate(3, 6)
    host_eval_s = time.perf_counter() - t0
    want_launches = ladder_launches(1)
    if launches != want_launches:
        raise AssertionError(f"dkg256 forced-device launches {launches}, expected {want_launches}")
    if not (row_best == row_host and row_dev == row_host):
        raise AssertionError("dkg256: commitment_row differs from com.row(3)")
    if not c.g1_eq(ev_dev, ev_host):
        raise AssertionError("dkg256: commitment_eval differs from com.evaluate(3, 6)")
    if com_dev.to_bytes() != com.to_bytes():
        raise AssertionError("dkg256: bivar_commitment differs from poly.commitment()")
    ctx["dkg256_launches"] = launches

    # bivar_commitment by degree
    bivar = []
    for t in BIVAR_SWEEP_T:
        p = tc.BivarPoly.random(t, random.Random(100 + t))
        h, h_s, d, d_s = _route_pair(B, ("DEVICE_BIVAR_MIN_BATCH",),
                                     lambda: B.bivar_commitment(p), reps=3)
        if h.to_bytes() != d.to_bytes():
            raise AssertionError(f"bivar_commitment at t={t}: the routes differ")
        bivar.append({"t": t, "muls": (t + 1) ** 2, "host_s": h_s, "device_s": d_s})
    # commitment_row / commitment_eval up to t = 85 (the commitments made on
    # the device); x and y as node indices are, small
    row, ev = [], []
    for t in ROW_SWEEP_T:
        p = tc.BivarPoly.random(t, random.Random(200 + t))
        with _thresholds(B, ("DEVICE_BIVAR_MIN_BATCH",), 1):
            cm = B.bivar_commitment(p)
        # from t = 85 one call a route: seconds each, nothing left to warm
        reps, warm = (3, True) if t < DKG_T else (1, False)
        h, h_s, d, d_s = _route_pair(B, ("DEVICE_ROW_MIN_BATCH",),
                                     lambda: B.commitment_row(cm, 3), reps, warm)
        if h != d:
            raise AssertionError(f"commitment_row at t={t}: the routes differ")
        row.append({"t": t, "muls": (t + 1) ** 2, "host_s": h_s, "device_s": d_s})
        h, h_s, d, d_s = _route_pair(B, ("DEVICE_EVAL_MIN_BATCH",),
                                     lambda: B.commitment_eval(cm, 3, 6), reps, warm)
        if not c.g1_eq(h, d):
            raise AssertionError(f"commitment_eval at t={t}: the routes differ")
        ev.append({"t": t, "muls": (t + 1) ** 2, "host_s": h_s, "device_s": d_s})

    # the fold: rlc_fold_g1's host loop against the device MSM
    pts = [p for r in com.points for p in r]
    fold = []
    for n in list(FOLD_SWEEP) + [len(pts)]:
        rs = B._fs_scalars(b"fold-crossover", n)
        h, h_s, d, d_s = _route_pair(B, ("DEVICE_FOLD_MIN_BATCH",),
                                     lambda: B.rlc_fold_g1(pts[:n], rs), reps=1)
        if not c.g1_eq(h, d):
            raise AssertionError(f"fold crossover: the device MSM differs at n={n}")
        fold.append({"n": n, "host_s": h_s, "device_s": d_s})

    # decryption-share generation (x·U for many ciphertexts, no KDF)
    rng = random.Random(31)
    sk = tc.SecretKey.random(rng)
    cts = [sk.public_key().encrypt(b"share-gen", rng) for _ in range(max(SHARE_GEN_SWEEP))]
    share_gen = []
    for n in SHARE_GEN_SWEEP:
        h, h_s, d, d_s = _route_pair(B, ("DEVICE_SHARE_GEN_MIN_BATCH",),
                                     lambda: B.batch_decrypt_share_gen(sk.scalar, cts[:n]),
                                     reps=1)
        if [s.to_bytes() for s in h] != [s.to_bytes() for s in d]:
            raise AssertionError(f"batch_decrypt_share_gen at n={n}: the routes differ")
        share_gen.append({"n": n, "host_s": h_s, "device_s": d_s})

    tpke = [_tpke_routes(B, tc, n, random.Random(41)) for n in TPKE_SWEEP_N]
    no_oracle = _no_oracle_encrypt(tc, c, random.Random(43))
    return {
        "t": DKG_T, "muls": muls, "best_route": best_route, "t_best_s": best_s,
        "t_device_s": dev_row_s, "t_host_s": host_row_s,
        "row_equal_on_both_routes": True, "forced_device_launches": launches,
        "eval_device_s": dev_eval_s, "eval_host_s": host_eval_s, "eval_equal": True,
        "commit_device_s": dev_commit_s, "commit_host_s": host_commit_s, "commit_equal": True,
        "bivar_crossover": bivar, "row_crossover": row, "eval_crossover": ev,
        "fold_crossover": fold, "share_gen_crossover": share_gen, "tpke": tpke,
        "encrypt_without_oracle": no_oracle,
        "device_from": {"bivar_commitment": _crossover(bivar, "muls"),
                        "commitment_row": _crossover(row, "muls"),
                        "commitment_eval": _crossover(ev, "muls"),
                        "rlc_fold_g1": _crossover(fold, "n"),
                        "batch_decrypt_share_gen": _crossover(share_gen, "n"),
                        "encrypt_without_oracle": _crossover(no_oracle, "n")},
        "thresholds": {n: getattr(B, n) for n in DKG_THRESHOLDS + (
            "DEVICE_FOLD_MIN_BATCH", "DEVICE_SHARE_GEN_MIN_BATCH", "DEVICE_DECRYPT_MIN_BATCH",
            "DEVICE_ENCRYPT_MIN_BATCH")},
    }


# the dhb cell: a membership change at DHB_N validators (one added: the
# new set has DHB_N + 1), small transactions; ``--dhb-n`` sets another N
DHB_N = 8
DHB_BATCH = 16
DHB_FILL = 64


def _pickle_without_cuda(torch, obj) -> bytes:
    """``pickle.dumps(obj)``, failing on any CUDA tensor in its state."""
    import io
    import pickle

    class Pickler(pickle.Pickler):
        def persistent_id(self, o):
            if isinstance(o, torch.Tensor) and o.device.type == "cuda":
                raise AssertionError("the pickled state holds a CUDA tensor")
            return None

    buf = io.BytesIO()
    Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _batch_key(b):
    """A DhbBatch as plain values (era, epoch, contributions, change)."""
    ch = b.change.change
    return (b.era, b.epoch, b.contributions, b.change.state,
            None if ch is None else (ch.kind, ch.new_keys, ch.schedule))


def phase_dhb(ctx):
    """Validator-set change on the card: ``BatchedQueueingDynamicHoneyBadger``
    over ``BatchedDynamicHoneyBadger`` at N = DHB_N (f = (N-1)//3), 2 plain
    epochs with queued transactions, a vote to add one validator with a
    fresh key, epochs until the batch reports ``complete``, then 2 epochs
    of the new era under the new keys.  Gates: the change completes, the
    new key set's threshold decrypt works, no transaction is committed
    twice, and a pickle of ``q`` after the rotation holds no CUDA tensor
    and, restored with ``device="cpu"``, runs the next epoch to the same
    batch as the original on the card.  The era change's seconds split into
    the epochs and the DKG's host work, with the ladder launches."""
    import pickle

    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.qhb import BatchedQueueingDynamicHoneyBadger

    n = ctx.get("dhb_n", DHB_N)
    t0 = time.perf_counter()
    nets = NetworkInfo.generate_map(list(range(n)), random.Random(7))
    q = BatchedQueueingDynamicHoneyBadger(
        nets, batch_size=DHB_BATCH, session_id=b"dhb-chip", rng=random.Random(77),
        device="cuda")
    dhb = q.dhb
    for nid in range(n):
        for j in range(DHB_FILL):
            q.push(nid, bytes([nid, j]) * (QHB_TX_BYTES // 2))
    setup_s = time.perf_counter() - t0

    # the DKG's host work: everything _process_batch does (vote counting,
    # every member's generate_part, handle_part and handle_ack)
    process = dhb._process_batch
    dkg_s = []

    def timed_process(batch_map):
        t = time.perf_counter()
        out = process(batch_map)
        dkg_s.append(time.perf_counter() - t)
        return out

    dhb._process_batch = timed_process
    rng = random.Random(5)

    def epoch():
        torch.cuda.synchronize()
        t = time.perf_counter()
        q.run_epoch(rng)
        torch.cuda.synchronize()
        b = dhb.batches[-1]
        return {"era": b.era, "epoch": b.epoch, "state": b.change.state,
                "validators": len(b.contributions), "s": time.perf_counter() - t,
                "process_batch_s": dkg_s[-1]}

    plain = [epoch() for _ in range(2)]
    if any(e["era"] != 0 or e["state"] != "none" for e in plain):
        raise AssertionError(f"dhb: plain epochs {plain}")
    sk_new = tc.SecretKey.random(random.Random(99))
    for voter in dhb.validators:
        q.vote_to_add(voter, n, sk_new.public_key(), secret_key=sk_new)
    _build.reset_launches()
    change = []
    while not change or change[-1]["state"] != "complete":
        if len(change) >= 8:
            raise AssertionError(f"dhb: the change did not complete: {change}")
        change.append(epoch())
    change_launches = dict(_build.LAUNCHES)
    ctx["dhb_launches"] = change_launches
    if dhb.era != 1 or dhb.validators != sorted(range(n + 1), key=repr):
        raise AssertionError("dhb: the era did not rotate to the new validator set")
    t_new = dhb.netinfo_map[0].public_key_set().threshold()
    bivar_on_device = B._device_worthwhile((t_new + 1) ** 2, B.DEVICE_BIVAR_MIN_BATCH)
    enc_on_device = B.device_encrypt_worthwhile(n, "cuda")
    want = ladder_launches((n + 1) * bivar_on_device + 2 * len(change) * enc_on_device)
    want["bitplane"] = EPOCH_BITPLANE_LAUNCHES * len(change)  # one RBC round an epoch
    got = {k: change_launches[k] for k in want}
    if got != want:
        raise AssertionError(f"dhb: launches {got}, expected {want}")
    era1 = [epoch() for _ in range(2)]
    if any(e["era"] != 1 or e["validators"] != n + 1 for e in era1):
        raise AssertionError(f"dhb: new-era epochs {era1}")

    # the new era's threshold decrypt, t + 1 of the new shares
    pks = dhb.netinfo_map[0].public_key_set()
    msg = b"dhb new-era threshold decrypt"
    ct = pks.public_key().encrypt(msg, random.Random(3))
    shares = {dhb.netinfo_map[nid].node_index(nid):
              dhb.netinfo_map[nid].secret_key_share().decrypt_share(ct)
              for nid in dhb.validators[: t_new + 1]}
    if pks.decrypt(shares, ct) != msg:
        raise AssertionError("dhb: the new era's threshold decrypt failed")
    if len(q.committed) != len(set(q.committed)):
        raise AssertionError("dhb: a transaction was committed twice")

    # snapshot after the rotation: host state only; restored on the CPU it
    # runs the next epoch to the original's batch
    del dhb._process_batch  # the timing wrapper above does not pickle
    blob = _pickle_without_cuda(torch, q)
    restored = pickle.loads(blob)
    restored.dhb.device = torch.device("cpu")
    q.run_epoch(random.Random(8))
    restored.run_epoch(random.Random(8))
    if restored.dhb.hb.device.type != "cpu":
        raise AssertionError("dhb: the restored driver did not run on the CPU")
    if (_batch_key(restored.dhb.batches[-1]) != _batch_key(dhb.batches[-1])
            or restored.committed != q.committed):
        raise AssertionError("dhb: the restored copy's epoch differs from the original's")
    change_s = sum(e["s"] for e in change)
    dkg_host_s = sum(e["process_batch_s"] for e in change)
    return {
        "n": n, "f": nets[0].num_faulty(), "new_n": n + 1, "new_t": t_new,
        "setup_s": setup_s, "plain_epochs": plain, "change_epochs": change, "era1_epochs": era1,
        "era_change_s": change_s,
        "era_change_split_s": {"dkg_host": dkg_host_s, "epochs": change_s - dkg_host_s},
        "era_change_launches": change_launches,
        "bivar_commitment_on_device": bivar_on_device, "encrypt_on_device": enc_on_device,
        "new_era_decrypt_ok": True, "committed_once": True, "txs_committed": len(q.committed),
        "snapshot_bytes": len(blob), "snapshot_no_cuda_tensor": True,
        "restored_cpu_epoch_equal": True,
    }


# objsim: object mode (QHB over DHB over VirtualNet, the simulation CLI).
# (a) N = 10 at the defaults of upstream poanetwork/hbbft's
# examples/simulation.rs: 1 000 transactions of 10 B, batches of 100, the
# JAX CLI's cost model (1 Gbit/s, 10 µs a message), run under the native
# erasure backend and under the device one.  (b) N = 22, f = 7: the
# smallest N whose t + 1 reaches DEVICE_FOLD_MIN_BATCH = 8, so every
# threshold-decrypt share-set fold runs the windowed ladder kernel.
OBJSIM_A = ["--nodes", "10", "--txs", "1000", "--tx-size", "10", "--batch-size", "100"]
# (b) one transaction a node: each node proposes at its first input, so all
# 22 commit in one epoch (220 took two, the first with one a node)
OBJSIM_B = ["--nodes", "22", "--txs", "22", "--tx-size", "10", "--batch-size", "220"]
OBJSIM_HOST_CHECKED_FOLDS = 32
OBJSIM_DEVICE = "cuda"
OBJSIM_FOLD_REPS = 21


@contextlib.contextmanager
def _erasure_backend(value: str):
    before = os.environ.get("HBBFT_ERASURE_BACKEND")
    os.environ["HBBFT_ERASURE_BACKEND"] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ["HBBFT_ERASURE_BACKEND"]
        else:
            os.environ["HBBFT_ERASURE_BACKEND"] = before


@contextlib.contextmanager
def _device_calls(B):
    """Wrap ``crypto/batch.py``'s share-set fold and share generation (the
    protocols import them at call time) to count the calls that take the
    device route, time them, and keep the first folds' inputs and result."""
    rec = {"folds": 0, "host_folds": 0, "share_gens": 0, "host_share_gens": 0,
           "device_s": 0.0, "kept": []}
    fold, gen = B.rlc_fold_g1, B.batch_decrypt_share_gen

    def counted_fold(points, scalars, device="cuda"):
        if not B._device_worthwhile(len(points), B.DEVICE_FOLD_MIN_BATCH):
            rec["host_folds"] += 1
            return fold(points, scalars, device=device)
        t = time.perf_counter()
        out = fold(points, scalars, device=device)
        rec["device_s"] += time.perf_counter() - t
        rec["folds"] += 1
        if len(rec["kept"]) < OBJSIM_HOST_CHECKED_FOLDS:
            rec["kept"].append((list(points), list(scalars), out))
        return out

    def counted_gen(scalar, cts, device="cuda"):
        key = ("share_gens" if B._device_worthwhile(len(cts), B.DEVICE_SHARE_GEN_MIN_BATCH)
               else "host_share_gens")
        rec[key] += 1
        t = time.perf_counter()
        out = gen(scalar, cts, device=device)
        if key == "share_gens":
            rec["device_s"] += time.perf_counter() - t
        return out

    B.rlc_fold_g1, B.batch_decrypt_share_gen = counted_fold, counted_gen
    try:
        yield rec
    finally:
        B.rlc_fold_g1, B.batch_decrypt_share_gen = fold, gen


@contextlib.contextmanager
def _timed_calls(targets):
    """Seconds and calls of each ``(owner, attribute, label)`` function
    while the block runs (labels may repeat: their counts add up)."""
    split = {label: {"s": 0.0, "calls": 0} for _, _, label in targets}
    saved = []
    for owner, name, label in targets:
        fn = vars(owner)[name]
        saved.append((owner, name, fn))

        def timed(*args, _fn=fn, _rec=split[label], **kw):
            t = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                _rec["s"] += time.perf_counter() - t
                _rec["calls"] += 1

        setattr(owner, name, timed)
    try:
        yield split
    finally:
        for owner, name, fn in reversed(saved):
            setattr(owner, name, fn)


def _host_split():
    """Seconds and calls of object mode's leaf host work while the block
    runs: the pairing checks, hash-to-G2 and G1/G2 scalar muls of
    ``crypto/bls12_381.py``, the Merkle trees' SHA3 (hashlib and the native
    batch hasher), the GF(2^8) erasure code and the event log's wire sizes
    (one ``encode_message`` a crank).  None of these calls another."""
    from hbbft_tpu_torch.crypto import bls12_381 as c
    from hbbft_tpu_torch.ops import merkle, rs
    from hbbft_tpu_torch.sim import trace

    merkle._sha3_batch()  # resolve the native batch hasher before wrapping it
    targets = [(c, "pairing_check", "pairing"), (c, "hash_g2", "hash_g2"),
               (c, "g1_mul", "g1_mul"), (c, "g2_mul", "g2_mul"),
               (merkle, "sha3_256_host", "merkle_sha3"),
               (rs.ReedSolomon, "_apply_matrix", "erasure"),
               (trace, "wire_size", "wire_size")]
    if merkle._batch_fn is not None:
        targets.append((merkle, "_batch_fn", "merkle_sha3"))
    return _timed_calls(targets)


def _objsim_run(argv, backend: str, split: bool = False):
    """One ``simulation.simulate`` run on cuda under the erasure ``backend``,
    then cranked to quiescence so every node closes the last epoch; the
    launch counts are zeroed just before and read just after.  Gates: every
    node's ledger equal, every transaction committed once, no fault."""
    import io

    import torch

    from hbbft_tpu_torch import _build, simulation
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.ops import rs
    from hbbft_tpu_torch.protocols import wire
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch

    buf = io.StringIO()
    stats0 = rs.stats_snapshot()
    host = _host_split() if split else contextlib.nullcontext()
    with _erasure_backend(backend), _device_calls(B) as calls, host as host_s:
        resolved = rs.resolve_backend()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run = simulation.simulate([*argv, "--device", OBJSIM_DEVICE])
        cli_s = time.perf_counter() - t0
        cranks_cli = run.net.cranks
        run.net.run_to_quiescence()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
    stats1 = rs.stats_snapshot()
    net, what = run.net, f"objsim {argv[1]} nodes, {backend}"
    ledgers = {nid: [o for o in net.nodes[nid].outputs if isinstance(o, QhbBatch)]
               for nid in net.node_ids()}
    ledger = [wire.batch_bytes(b) for b in ledgers[0]]
    if any([wire.batch_bytes(b) for b in v] != ledger for v in ledgers.values()):
        raise AssertionError(f"{what}: the nodes' ledgers differ")
    seen = [tx for b in ledgers[0] for _, txs in b.contributions for tx in txs]
    if sorted(seen) != sorted(run.txs):
        raise AssertionError(f"{what}: {len(seen)} commits of {len(set(seen))} distinct "
                             f"transactions, {len(run.txs)} sent: not each once")
    faults = {nid: len(net.nodes[nid].faults_observed) for nid in net.node_ids()}
    if any(faults.values()):
        raise AssertionError(f"{what}: faults logged {faults}")
    # one ladder launch a device fold or share generation, one bit-plane
    # launch a product of the device erasure backend, no other
    expected = {**{k: 0 for k in launches}, "ladder_window": calls["folds"] + calls["share_gens"],
                "bitplane": stats1["device"]["calls"] - stats0["device"]["calls"]}
    if launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected} (device "
                             "folds + share generations, device erasure products)")
    messages = len(run.trace)
    return run, {
        "backend": backend, "resolved_backend": resolved,
        "nodes": len(net.node_ids()), "txs": len(run.txs),
        "epochs": len(ledger), "cli_s": cli_s, "crank_loop_s": run.wall_s,
        "cranks_cli": cranks_cli, "cranks": net.cranks, "messages": messages,
        "messages_per_s": messages / run.wall_s, "wire_bytes": run.trace.total_bytes(),
        "virtual_time_s": net.virtual_time, "launches": launches,
        "device_folds": calls["folds"], "host_folds": calls["host_folds"],
        "device_share_gens": calls["share_gens"], "host_share_gens": calls["host_share_gens"],
        "device_route_s": calls["device_s"],
        "erasure_stats": {b: {k: stats1[b][k] - stats0[b][k] for k in stats1[b]}
                          for b in stats1},
        "table": buf.getvalue().splitlines(),
        **({"host_split": host_s} if split else {}),
    }, calls


def phase_objsim(ctx):
    """Object mode on the card through the simulation CLI: (a) N = 10 under
    the native and the device erasure backend, equal in ledgers, message
    counts, wire bytes and virtual time; (b) N = 22, where the share-set
    folds take the windowed ladder kernel: one launch a fold of ≥ 8 rows,
    and the first OBJSIM_HOST_CHECKED_FOLDS folds equal to the host loop."""
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import bls12_381 as c

    out = {"smi": ctx["smi"]}
    runs = {}
    for backend in ("auto", "device"):
        run, rec, _ = _objsim_run(OBJSIM_A, backend)
        runs[backend] = run
        out[f"n10_{backend}"] = rec
    if out["n10_device"]["erasure_stats"]["device"]["calls"] == 0:
        raise AssertionError("objsim: the device erasure backend ran no product")
    ctx["objsim10_device_launches"] = out["n10_device"]["launches"]

    def signature(run):
        from hbbft_tpu_torch.protocols import wire
        from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch

        return ([wire.batch_bytes(o) for o in run.net.nodes[0].outputs
                 if isinstance(o, QhbBatch)],
                run.trace.messages_by_type(), run.trace.bytes_by_type(),
                run.trace.total_bytes(), run.net.virtual_time, run.net.cranks)

    if signature(runs["auto"]) != signature(runs["device"]):
        raise AssertionError("objsim: N = 10 differs between the native and the device "
                             "erasure backends")
    out["n10_backends_equal"] = True

    run, rec, calls = _objsim_run(OBJSIM_B, "auto", split=True)
    if rec["device_folds"] == 0 or rec["host_folds"]:
        raise AssertionError(f"objsim N = 22: folds {rec['device_folds']} on the device, "
                             f"{rec['host_folds']} on the host")
    for i, (points, scalars, got) in enumerate(calls["kept"]):
        want = None
        for pt, sc in zip(points, scalars):
            want = c.g1_add(want, c.g1_mul(pt, sc))
        if (got is None) != (want is None) or (got is not None and not c.g1_eq(got, want)):
            raise AssertionError(f"objsim N = 22: device fold {i} differs from the host loop")
    rec["host_checked_folds"] = len(calls["kept"])
    rec["fold_rows"] = sorted({len(p) for p, _, _ in calls["kept"]})
    # one share-set fold (8 shares, full-range coefficients) by each route,
    # median of OBJSIM_FOLD_REPS calls: the device route against the host
    # loop it replaces at N ≥ 22
    points, scalars, _ = calls["kept"][0]
    saved = B.DEVICE_FOLD_MIN_BATCH
    times = {}
    try:
        for route, threshold in (("device", saved), ("host", None)):
            B.DEVICE_FOLD_MIN_BATCH = threshold
            B.rlc_fold_g1(points, scalars, device=OBJSIM_DEVICE)
            reps = []
            for _ in range(OBJSIM_FOLD_REPS):
                t = time.perf_counter()
                B.rlc_fold_g1(points, scalars, device=OBJSIM_DEVICE)
                reps.append((time.perf_counter() - t) * 1e3)
            times[route] = statistics.median(reps)
    finally:
        B.DEVICE_FOLD_MIN_BATCH = saved
    rec["fold_ms"] = {"rows": len(points), "reps": OBJSIM_FOLD_REPS, **times}
    out["n22"] = rec
    ctx["objsim_launches"] = rec["launches"]
    ctx["objsim_folds"] = rec["device_folds"]
    return out


# vidsim: the node stack without the network.  Every node is the standard
# stack of the reference's net/cluster.py build_algo with encryption always
# (ClusterConfig.encrypt): SenderQueue over VidQueueingHoneyBadger (a) or
# QueueingHoneyBadger (b) over DynamicHoneyBadger, per-node seeded RNGs,
# batches of 64, on VirtualNet at N = 22, f = 7, keys from objsim (b)'s seed
# and its cost model.  Each node holds 64 distinct transactions of 250 B
# (the HoneyBadgerBFT paper's size), so a proposal is ~16 KB.  Every link of
# node 21 is capped (preset_shape("bandwidth-asym", 22), scaled by 1e-3 to
# the virtual clock, as the chaos campaign scales a preset it has no entry
# for).  The device erasure backend; t + 1 = 8 sends every share-set fold to
# the windowed ladder kernel.
VIDSIM_N = 22
VIDSIM_KEY_SEED = 0  # objsim (b): simulation.py --seed 0
VIDSIM_BATCH = 64
VIDSIM_TXS_PER_NODE = 64
VIDSIM_TX_BYTES = 250
VIDSIM_SHAPE = "bandwidth-asym"
VIDSIM_TIME_SCALE = 1e-3
VIDSIM_DEVICE = "cuda"


def _vidsim_txs(nid: int):
    rng = random.Random(31_000 + nid)
    return [b"%02d-%02d-" % (nid, i) + rng.randbytes(VIDSIM_TX_BYTES - 6)
            for i in range(VIDSIM_TXS_PER_NODE)]


def _vidsim_net(nets, vid: bool, trace):
    """The N = 22 network of node stacks, each node's queue holding all but
    one of its transactions; the last one, given as a ``TxInput``, makes the
    node propose all 64 at once."""
    from hbbft_tpu_torch.chaos.link import preset_shape
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.honey_badger import EncryptionSchedule
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
    from hbbft_tpu_torch.protocols.sender_queue import SenderQueue
    from hbbft_tpu_torch.protocols.vid import VidQueueingHoneyBadger
    from hbbft_tpu_torch.sim import CostModel, NetBuilder

    def build_algo(nid):
        dhb = DynamicHoneyBadger(
            nets[nid], nets[nid].secret_key(), rng=random.Random(7000 + nid),
            encryption_schedule=EncryptionSchedule.always(), device=VIDSIM_DEVICE)
        cls = VidQueueingHoneyBadger if vid else QueueingHoneyBadger
        qhb = cls(dhb, batch_size=VIDSIM_BATCH, rng=random.Random(8000 + nid))
        qhb.queue.extend(_vidsim_txs(nid)[:-1])
        return SenderQueue(qhb)

    shape = preset_shape(VIDSIM_SHAPE, VIDSIM_N).scaled(VIDSIM_TIME_SCALE)
    return (NetBuilder(list(range(VIDSIM_N))).trace(trace).cost_model(CostModel())
            .shape(shape, seed=0).using_step(build_algo))


def _coder_calls(rs):
    """The GF(2^8) coder's host-API encodes and reconstructions (each
    reconstruction is two products: the decode, then the re-encode)."""
    return _timed_calls([(rs.ReedSolomon, "encode_into", "encodes"),
                         (rs.ReedSolomon, "reconstruct_np", "reconstructs")])


def _vid_stages():
    """VID's own stages: the dispersal (encode, Merkle tree, our vote), each
    vote's pairing check, each received shard's proof check and vote, and
    each certificate's aggregated check at batch decode."""
    from hbbft_tpu_torch.protocols import vid

    return _timed_calls([(vid.Disperser, "disperse", "disperse"),
                         (vid.Disperser, "handle_vote", "handle_vote"),
                         (vid.Disperser, "handle_disperse", "handle_disperse"),
                         (vid, "verify_cert", "verify_cert")])


def _retrieve_all(net, n: int, f: int):
    """Every node retrieves every commitment it did not propose from k = n −
    2f shards: a plain FIFO loop between the nodes' ``RetrieveService``s
    (the node runtime's routing of VidRetrieve / VidShard).  Returns the
    services, each node's ``RetrievedPayload``s and the faults."""
    from collections import deque

    from hbbft_tpu_torch.net import RetrieveService
    from hbbft_tpu_torch.protocols.vid import VidQhbBatch, VidRetrieve

    ids = net.node_ids()
    ni = net.nodes[ids[0]].algorithm.algo.dhb.netinfo
    holders = tuple(sorted(ids, key=ni.node_index))
    services = {nid: RetrieveService(nid, net.nodes[nid].algorithm.algo.store,
                                     device=VIDSIM_DEVICE) for nid in ids}
    queue, got, faults = deque(), {nid: [] for nid in ids}, []

    def absorb(nid, step):
        for tm in step.messages:
            for dest in tm.target.resolve(ids, nid):
                queue.append((nid, dest, tm.message))
        got[nid].extend(step.output)
        faults.extend((nid, fl.node_id, fl.kind.name) for fl in step.fault_log.faults)

    for nid in ids:
        for out in net.nodes[nid].outputs:
            if isinstance(out, VidQhbBatch):
                for proposer, cert in out.commitments():
                    if proposer != nid:
                        absorb(nid, services[nid].start(
                            cert.root, cert.total_len, n, f, proposer, now=0.0,
                            t_ordered=0.0, holders=holders))
    while queue:
        src, dst, msg = queue.popleft()
        if isinstance(msg, VidRetrieve):
            absorb(dst, services[dst].handle_retrieve(src, msg, 0.0))
        else:
            absorb(dst, services[dst].handle_shard(src, msg, 0.0))
    return services, got, faults


def _vidsim_snapshot(torch, stack, crank: int):
    """(c): snapshot a stack mid-run; taken twice it is byte-identical, the
    restored stack snapshots to the same bytes, and neither pickle holds a
    CUDA tensor."""
    from hbbft_tpu_torch import snapshot

    t = time.perf_counter()
    blob = snapshot.snapshot(stack)
    plain = _pickle_without_cuda(torch, stack)  # raises on a CUDA tensor
    restored = snapshot.restore(blob)
    _pickle_without_cuda(torch, restored)
    if snapshot.snapshot(stack) != blob or snapshot.snapshot(restored) != blob:
        raise AssertionError("vidsim (c): the snapshot is not byte-identical (taken "
                             "twice, or of the restored stack)")
    return {"crank": crank, "bytes": len(blob), "plain_pickle_bytes": len(plain),
            "seconds": time.perf_counter() - t, "byte_identical": True,
            "restored_identical": True, "no_cuda_tensor": True,
            "restored_type": type(restored).__name__,
            "restored_device": str(restored.algo.dhb.device)}


def _vidsim_run(nets, vid: bool):
    """One stack to quiescence on the card under the device erasure backend,
    launch counts zeroed just before and read just after; for the VID stack
    node 0 is snapshotted after its first committed epoch (outside the
    timed crank loop), and every commitment is retrieved after the loop."""
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.ops import rs
    from hbbft_tpu_torch.protocols.queueing_honey_badger import TxInput
    from hbbft_tpu_torch.sim import EventLog

    trace = EventLog()
    net = _vidsim_net(nets, vid, trace)
    stats0 = rs.stats_snapshot()
    run = {"snapshot": None, "loop_s": 0.0}
    with (_erasure_backend("device"), _device_calls(B) as calls, _coder_calls(rs) as coder,
          _host_split() as host_s, _vid_stages() as vid_s):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        for nid in net.node_ids():
            net.send_input(nid, TxInput(_vidsim_txs(nid)[-1]))
        while net.crank() is not None:
            if vid and run["snapshot"] is None and any(
                    type(o).__name__ == "VidQhbBatch" for o in net.nodes[0].outputs):
                run["loop_s"] += time.perf_counter() - t0
                run["snapshot"] = _vidsim_snapshot(torch, net.nodes[0].algorithm, net.cranks)
                t0 = time.perf_counter()
        torch.cuda.synchronize()
        run["loop_s"] += time.perf_counter() - t0
        run["launches"] = dict(_build.LAUNCHES)
    stats1 = rs.stats_snapshot()
    run.update(calls=calls, coder={k: v["calls"] for k, v in coder.items()},
               host_split=host_s, vid_stages=vid_s,
               erasure={b: {k: stats1[b][k] - stats0[b][k] for k in stats1[b]}
                        for b in stats1})
    if vid:
        with _erasure_backend("device"), _coder_calls(rs) as rcoder:
            t1 = time.perf_counter()
            run["services"], run["retrieved"], rfaults = _retrieve_all(
                net, VIDSIM_N, nets[0].num_faulty())
            torch.cuda.synchronize()
            run["retrieval"] = {"s": time.perf_counter() - t1, "faults": rfaults,
                                "coder": {k: v["calls"] for k, v in rcoder.items()},
                                "device_products": rs.STATS["device"]["calls"]
                                - stats1["device"]["calls"]}
    return net, trace, run


def _vidsim_check(net, run, vid: bool, all_txs):
    """The gates of one stack: equal ordered sequences on every node, every
    transaction committed once, no fault, one ladder_window launch a device
    fold and no other launch, every erasure product on the device."""
    from hbbft_tpu_torch.protocols import wire
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QhbBatch, _de_txs
    from hbbft_tpu_torch.protocols.vid import VidQhbBatch

    what = "vidsim (a) VID" if vid else "vidsim (b) classic"
    kind = VidQhbBatch if vid else QhbBatch
    ids = net.node_ids()
    batches = {nid: [o for o in net.nodes[nid].outputs if isinstance(o, kind)] for nid in ids}
    seq = [wire.batch_bytes(b) for b in batches[0]]
    if not seq or any([wire.batch_bytes(b) for b in v] != seq for v in batches.values()):
        raise AssertionError(f"{what}: the nodes' ordered sequences differ")
    faults = {nid: len(net.nodes[nid].faults_observed) for nid in ids}
    if any(faults.values()):
        raise AssertionError(f"{what}: faults logged {faults}")
    if not net.quiescent:
        raise AssertionError(f"{what}: the net is not quiescent")
    out = {"epochs": len(seq)}
    if vid:
        certs = {nid: [(p, wire.encode_message(c)) for b in batches[nid]
                       for p, c in b.commitments()] for nid in ids}
        if any(v != certs[0] for v in certs.values()) or len(certs[0]) != VIDSIM_N:
            raise AssertionError(f"{what}: the nodes order different (proposer, cert) lists")
        svc, got = run["services"], run["retrieved"]
        own = {nid: net.nodes[nid].algorithm.algo.disperser for nid in ids}
        mism = sum(s.mismatches for s in svc.values())
        fail = sum(s.failures for s in svc.values())
        if mism or fail or run["retrieval"]["faults"]:
            raise AssertionError(f"{what}: retrieval mismatches {mism}, failures {fail}, "
                                 f"faults {run['retrieval']['faults']}")
        ledgers = {}
        for nid in ids:
            by_root = {rp.root: rp for rp in got[nid]}
            txs = []
            for b in batches[nid]:
                for proposer, cert in b.commitments():
                    if proposer == nid:
                        payload = own[nid].local_payload(cert.root)
                    else:
                        rp = by_root[cert.root]
                        payload = rp.payload
                        if payload != own[proposer].local_payload(cert.root):
                            raise AssertionError(f"{what}: node {nid}'s retrieval of "
                                                 f"{proposer}'s payload differs")
                    txs.extend(_de_txs(payload))
                for _, plain in b.plain_txs():
                    txs.extend(plain)
            ledgers[nid] = txs
        retrieved = sum(s.retrieved for s in svc.values())
        if retrieved != VIDSIM_N * (VIDSIM_N - 1):
            raise AssertionError(f"{what}: {retrieved} retrievals, want "
                                 f"{VIDSIM_N * (VIDSIM_N - 1)}")
        if run["retrieval"]["device_products"] != 2 * run["retrieval"]["coder"]["reconstructs"] \
                or run["retrieval"]["coder"]["reconstructs"] != retrieved:
            raise AssertionError(f"{what}: retrieval's products {run['retrieval']}")
        out.update(
            certificates=len(certs[0]),
            dispersals=sum(d.disperses for d in own.values()),
            votes_cast=sum(d.votes_cast for d in own.values()),
            certs_built=sum(d.certs for d in own.values()),
            retrieval={"s": run["retrieval"]["s"], "retrieved": retrieved,
                       "retrieves": sum(s.retrieves for s in svc.values()),
                       "served": sum(s.served for s in svc.values()),
                       "retries": sum(s.retries for s in svc.values()),
                       "refusals": sum(s.refusals for s in svc.values()),
                       "quota_drops": sum(s.quota_drops for s in svc.values()),
                       "mismatches": mism, "failures": fail,
                       "reconstructions": run["retrieval"]["coder"]["reconstructs"],
                       "device_products": run["retrieval"]["device_products"]})
    else:
        ledgers = {nid: [tx for b in batches[nid] for _, txs in b.contributions for tx in txs]
                   for nid in ids}
    if any(v != ledgers[0] for v in ledgers.values()):
        raise AssertionError(f"{what}: the nodes' ledgers differ")
    if sorted(ledgers[0]) != sorted(all_txs):
        raise AssertionError(f"{what}: {len(ledgers[0])} commits of {len(set(ledgers[0]))} "
                             f"distinct transactions, {len(all_txs)} given: not each once")
    calls, launches, er = run["calls"], run["launches"], run["erasure"]
    expected = {**{k: 0 for k in launches}, "ladder_window": calls["folds"] + calls["share_gens"],
                "bitplane": er["device"]["calls"]}
    if calls["folds"] == 0 or calls["host_folds"] or launches != expected:
        raise AssertionError(f"{what}: launches {launches}, expected {expected}; device folds "
                             f"{calls['folds']}, host folds {calls['host_folds']}")
    coder = run["coder"]
    if er["native"]["calls"] or er["numpy"]["calls"] or \
            er["device"]["calls"] != coder["encodes"] + 2 * coder["reconstructs"]:
        raise AssertionError(f"{what}: erasure products {er}, coder calls {coder}")
    if vid and coder["encodes"] < out["dispersals"]:
        raise AssertionError(f"{what}: {coder['encodes']} encodes for "
                             f"{out['dispersals']} dispersals")
    out.update(committed=len(ledgers[0]), committed_once=True, faults=0)
    return out


def phase_vidsim(ctx):
    """The node stack without the network at N = 22 on the card: (a) the VID
    stack to quiescence, a snapshot of node 0 after its first committed
    epoch, then every commitment retrieved; (b) the classic stack on the
    same network, transactions and shape."""
    import torch  # noqa: F401

    from hbbft_tpu_torch.netinfo import NetworkInfo

    nets = NetworkInfo.generate_map(list(range(VIDSIM_N)), random.Random(VIDSIM_KEY_SEED))
    all_txs = [tx for nid in range(VIDSIM_N) for tx in _vidsim_txs(nid)]
    out = {"smi": ctx["smi"], "n": VIDSIM_N, "f": nets[0].num_faulty(),
           "batch_size": VIDSIM_BATCH, "txs": len(all_txs), "tx_bytes": VIDSIM_TX_BYTES,
           "shape": f"{VIDSIM_SHAPE} x {VIDSIM_TIME_SCALE}"}
    launches = {}
    for key, vid in (("vid", True), ("classic", False)):
        net, trace, run = _vidsim_run(nets, vid)
        rec = _vidsim_check(net, run, vid, all_txs)
        calls = run["calls"]
        rec.update({
            "crank_loop_s": run["loop_s"], "cranks": net.cranks,
            "messages": net.messages_delivered, "messages_per_s": net.messages_delivered / run["loop_s"],
            "wire_bytes": trace.total_bytes(), "virtual_time_s": net.virtual_time,
            "shaper": net.shaper.stats(), "shaper_counters": dict(net.shaper.counters),
            "sender_queue_buffered_peak": max(net.nodes[nid].algorithm.buffered_peak
                                              for nid in net.node_ids()),
            "launches": run["launches"], "device_folds": calls["folds"],
            "host_folds": calls["host_folds"], "device_share_gens": calls["share_gens"],
            "device_route_s": calls["device_s"],
            "erasure_stats": run["erasure"], "coder_calls": run["coder"],
            "host_split": run["host_split"], "vid_stages": run["vid_stages"],
        })
        if vid:
            rec["snapshot"] = run["snapshot"]
            if rec["snapshot"] is None:
                raise AssertionError("vidsim (a): node 0 committed no epoch to snapshot after")
        out[key] = rec
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    ctx["vidsim_launches"] = launches
    ctx["vidsim_folds"] = out["vid"]["device_folds"] + out["classic"]["device_folds"]
    return out


# netsim: the node runtime over real sockets.  An in-process LocalCluster
# of N = 22 (f = 7) NodeRuntimes on this process's event loop, each with its
# own StepPump worker thread, over localhost TCP on ephemeral ports: the
# deployment the reference's examples/cluster.py runs, at objsim's and
# vidsim's N.  encrypt=True, batches of 64, 250-byte transactions (the
# HoneyBadgerBFT paper's size), each distinct and submitted through a
# ClusterClient connected to its own node; the flight recorder on; the
# device erasure backend.  (a) the classic stack, pipeline depth 2, 64
# transactions a node; (b) the VID stack, 64 a node, whose payloads the
# runtimes' own RetrieveServices fetch.  Every share-set check goes through
# the pump's deferred seam: verify_dec_share_sets, two rlc_fold_g1 a job,
# each a ladder_window launch at t + 1 = 8 rows.
NETSIM_N = 22
NETSIM_BATCH = 64
NETSIM_TX_BYTES = 250
# the mempool's per-transaction ceiling: 64 of them must fit half a wire blob
NETSIM_MAX_TX_BYTES = 4096
NETSIM_STACKS = (("classic", False, 64, 2), ("vid", True, 64, 1))  # name, vid, txs a node, depth
NETSIM_DEVICE = "cuda"
NETSIM_BUDGET_S = 400.0  # one stack, start to stop
NETSIM_STOP_S = 10.0
NETSIM_SEGMENTS = ("msg", "deferred", "flush", "recv")
# One interpreter hosts all 22 pump threads and the event loop that serves
# every node's sockets, so the loop waits behind the pumps for the
# interpreter lock on every syscall and stalls for seconds under load
# (``loop_lag_s`` in the phase's record).  At the defaults (pings every
# 0.5 s, dead after 3 s) the pings alone keep it busy and stalled links are
# declared dead and re-handshaken; a deployment runs a process a node.
# Slower pings and a longer dead window keep the links up here.
NETSIM_HEARTBEAT_S = 5.0
NETSIM_DEAD_AFTER_S = 30.0


def _netsim_txs(name: str, nid: int, count: int):
    rng = random.Random(hashlib.sha3_256(b"netsim-%s-%d" % (name.encode(), nid)).digest())
    out = []
    for i in range(count):
        head = b"%s-%02d-%03d-" % (name.encode(), nid, i)
        out.append(head + rng.randbytes(NETSIM_TX_BYTES - len(head)))
    return out


@contextlib.contextmanager
def _netsim_spies(B, rs):
    """Thread-safe counts of the runtimes' device seams while the block
    runs (22 pump threads call them at once): ``verify_dec_share_sets``
    calls, their jobs and devices; ``rlc_fold_g1`` by route; share
    generation by route; the erasure products and their host-timed
    seconds (copies and thread waits included)."""
    lock = threading.Lock()
    rec = {"verify_calls": 0, "jobs": 0, "jobs_per_call_max": 0, "verify_s": 0.0,
           "devices": set(), "folds": 0, "host_folds": 0, "fold_s": 0.0,
           "share_gens": 0, "host_share_gens": 0, "products": 0, "product_s": 0.0,
           "first_fold_at": None, "first_product_at": None}
    verify, fold, gen = B.verify_dec_share_sets, B.rlc_fold_g1, B.batch_decrypt_share_gen
    apply = rs.ReedSolomon._apply_matrix

    def spy_verify(jobs, device="cuda"):
        t = time.perf_counter()
        out = verify(jobs, device=device)
        dt = time.perf_counter() - t
        with lock:
            rec["verify_calls"] += 1
            rec["jobs"] += len(jobs)
            rec["jobs_per_call_max"] = max(rec["jobs_per_call_max"], len(jobs))
            rec["verify_s"] += dt
            rec["devices"].add(str(device))
        return out

    def spy_fold(points, scalars, device="cuda"):
        on_device = B._device_worthwhile(len(points), B.DEVICE_FOLD_MIN_BATCH)
        t = time.perf_counter()
        out = fold(points, scalars, device=device)
        dt = time.perf_counter() - t
        with lock:
            rec["folds" if on_device else "host_folds"] += 1
            rec["fold_s"] += dt
            rec["first_fold_at"] = rec["first_fold_at"] or [time.time() - dt, dt]
        return out

    def spy_gen(scalar, cts, device="cuda"):
        on_device = B._device_worthwhile(len(cts), B.DEVICE_SHARE_GEN_MIN_BATCH)
        out = gen(scalar, cts, device=device)
        with lock:
            rec["share_gens" if on_device and cts else "host_share_gens"] += 1
        return out

    def spy_apply(self, *args, **kw):
        t = time.perf_counter()
        out = apply(self, *args, **kw)
        dt = time.perf_counter() - t
        with lock:
            rec["products"] += 1
            rec["product_s"] += dt
            rec["first_product_at"] = rec["first_product_at"] or [time.time() - dt, dt]
        return out

    B.verify_dec_share_sets, B.rlc_fold_g1, B.batch_decrypt_share_gen = (
        spy_verify, spy_fold, spy_gen)
    rs.ReedSolomon._apply_matrix = spy_apply
    try:
        yield rec
    finally:
        B.verify_dec_share_sets, B.rlc_fold_g1, B.batch_decrypt_share_gen = verify, fold, gen
        rs.ReedSolomon._apply_matrix = apply


async def _netsim_settle(cluster, vid: bool, timeout_s: float) -> None:
    """Until every runtime holds the same number of batches and, in VID
    mode, no retrieval is pending."""
    async def settled():
        while True:
            counts = {len(rt.batches) for rt in cluster.runtimes}
            pending = sum(rt._retrieve.pending_count() for rt in cluster.runtimes) if vid else 0
            if len(counts) == 1 and not pending:
                return
            await asyncio.sleep(0.05)

    await asyncio.wait_for(settled(), timeout_s)


async def _netsim_stack(name: str, vid: bool, per_node: int, depth: int, flight_root: str):
    """One LocalCluster from start to stop: submit every node's transactions
    through its own client, wait for every commit, settle, read every node's
    /status, check the gates, stop.  Returns the stack's record."""
    from hbbft_tpu_torch.net import ClusterConfig, LocalCluster, framing
    from hbbft_tpu_torch.net.client import latency_percentiles
    from hbbft_tpu_torch.obs.http import http_get

    n = NETSIM_N
    cfg = ClusterConfig(n=n, encrypt=True, vid=vid, batch_size=NETSIM_BATCH,
                        max_tx_bytes=NETSIM_MAX_TX_BYTES, pipeline_depth=depth,
                        flight_dir=flight_root, device=NETSIM_DEVICE,
                        heartbeat_s=NETSIM_HEARTBEAT_S, dead_after_s=NETSIM_DEAD_AFTER_S)
    txs = {i: _netsim_txs(name, i, per_node) for i in range(n)}
    what = f"netsim ({name})"
    cluster = LocalCluster(cfg)
    rec = {"stack": name, "vid": vid, "pipeline_depth": depth, "txs_per_node": per_node,
           "txs": n * per_node}
    lags = []

    async def loop_lag():  # how late a 50 ms sleep wakes: the loop's stalls
        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.05)
            lags.append(time.perf_counter() - t - 0.05)

    lag_task = asyncio.ensure_future(loop_lag())
    t_start = time.perf_counter()
    try:
        await cluster.start()
        rec["start_s"] = time.perf_counter() - t_start
        clients = [await cluster.client(i, client_id=f"netsim-{i}") for i in range(n)]
        t0 = time.perf_counter()
        acks = await asyncio.gather(*(c.submit_many(txs[i], ack_timeout_s=NETSIM_BUDGET_S)
                                      for i, c in enumerate(clients)))
        if any(a != framing.ACK_ACCEPTED for ack in acks for a in ack):
            raise AssertionError(f"{what}: a submission was not accepted: "
                                 f"{sorted({a for ack in acks for a in ack})}")
        rec["submit_s"] = time.perf_counter() - t0
        await asyncio.gather(*(c.wait_committed_many(txs[i], timeout_s=NETSIM_BUDGET_S)
                               for i, c in enumerate(clients)))
        wall = time.perf_counter() - t0
        await _netsim_settle(cluster, vid, 60.0)
        docs = []
        for i in range(n):
            host, port = cluster.metrics_addrs[i]
            docs.append(json.loads(await asyncio.to_thread(http_get, host, port, "/status")))
        prefix = cluster.common_digest_prefix()
        epochs = len(cluster.runtimes[0].batches)
        lat = latency_percentiles(lat for c in clients for _d, lat in c.latencies)
        seg = {k: sum(rt._pump_seg[k].sum for rt in cluster.runtimes) for k in NETSIM_SEGMENTS}
        rec.update({
            "wall_to_last_commit_s": wall, "epochs": epochs, "tx_per_s": n * per_node / wall,
            "latency": lat, "digest_prefix_len": len(prefix),
            "pump_segment_s": seg,
            "pump_iterations": sum(rt.pump.iterations for rt in cluster.runtimes),
            "pump_offloaded": sum(rt.pump.offloaded for rt in cluster.runtimes),
            "loop_lag_s": {"p50": statistics.median(lags), "max": max(lags),
                           "samples": len(lags)},
            "dead_peer_events": sum(d["stats"]["dead_peer_events"] for d in docs),
            "status": {k: sorted({d[k] for d in docs}) for k in
                       ("committed_txs", "decode_failures", "peers_connected", "batches")},
            "flight": {"records": sum(d["flight"]["records"] for d in docs),
                       "records_min": min(d["flight"]["records"] for d in docs),
                       "bytes": sum(d["flight"]["bytes"] for d in docs),
                       "write_failures": sum(d["flight"]["write_failures"] for d in docs)},
        })
        if vid:
            rec["vid_status"] = {k: sum(d["vid"][k] for d in docs) for k in
                                 ("disperse", "cert", "retrieve", "retrieved", "mismatch",
                                  "failure", "retry", "shard_served", "pending_retrievals")}
        # the gates
        if len(prefix) < epochs or any(len(rt.batches) != epochs for rt in cluster.runtimes):
            raise AssertionError(f"{what}: common digest prefix {len(prefix)} of {epochs} "
                                 "epochs")
        if rec["status"]["committed_txs"] != [n * per_node]:
            raise AssertionError(f"{what}: committed_txs by node {rec['status']['committed_txs']}"
                                 f", want {n * per_node} on every node (each once)")
        if rec["status"]["decode_failures"] != [0] or rec["status"]["peers_connected"] != [n - 1]:
            bad = {i: (d["stats"]["dead_peer_events"], d["stats"]["reconnects"])
                   for i, d in enumerate(docs) if d["peers_connected"] != n - 1}
            raise AssertionError(f"{what}: status {rec['status']}; nodes short of peers "
                                 f"(dead-peer events, reconnects): {bad}")
        if rec["flight"]["records_min"] <= 0 or rec["flight"]["write_failures"]:
            raise AssertionError(f"{what}: flight {rec['flight']}")
        if vid:
            v = rec["vid_status"]
            want = 0
            for b in cluster.runtimes[0].batches:
                want += sum(1 for _p, _c in b.commitments())
            if v["mismatch"] or v["failure"] or v["pending_retrievals"] \
                    or v["retrieved"] != want * (n - 1):
                raise AssertionError(f"{what}: retrieval {v}, want {want * (n - 1)} "
                                     "retrieved, no mismatch or failure")
    finally:
        lag_task.cancel()
        t_stop = time.perf_counter()
        await asyncio.wait_for(cluster.stop(), NETSIM_STOP_S * 3)
        rec["stop_s"] = time.perf_counter() - t_stop
    if rec["stop_s"] > NETSIM_STOP_S:
        raise AssertionError(f"{what}: LocalCluster.stop() took {rec['stop_s']:.1f} s")
    rec["run_s"] = time.perf_counter() - t_start
    return rec


def phase_netsim(ctx):
    """The node runtime over real sockets at N = 22 on the card: (a) the
    classic stack at pipeline depth 2, (b) the VID stack; every gate of
    ``_netsim_stack``, one ``ladder_window`` launch a device fold, two
    folds a merged share-set job, every erasure product on the device."""
    import tempfile

    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.ops import rs

    out = {"smi": ctx["smi"], "n": NETSIM_N, "batch_size": NETSIM_BATCH,
           "tx_bytes": NETSIM_TX_BYTES, "device": NETSIM_DEVICE}
    launches = {}
    for name, vid, per_node, depth in NETSIM_STACKS:
        what = f"netsim ({name})"
        with tempfile.TemporaryDirectory() as root, _erasure_backend("device"), \
                _netsim_spies(B, rs) as spy:
            stats0 = rs.stats_snapshot()
            torch.cuda.synchronize()
            _build.reset_launches()
            rec = asyncio.run(asyncio.wait_for(
                _netsim_stack(name, vid, per_node, depth, root), NETSIM_BUDGET_S))
            torch.cuda.synchronize()
            got = dict(_build.LAUNCHES)
            stats1 = rs.stats_snapshot()
        er = {b: {k: stats1[b][k] - stats0[b][k] for k in stats1[b]} for b in stats1}
        spy["devices"] = sorted(spy["devices"])
        expected = {**{k: 0 for k in got}, "ladder_window": 2 * spy["jobs"] + spy["share_gens"],
                    "bitplane": er["device"]["calls"]}
        if spy["jobs"] == 0 or spy["host_folds"] or spy["folds"] != 2 * spy["jobs"] \
                or got != expected or spy["devices"] != [NETSIM_DEVICE]:
            raise AssertionError(f"{what}: launches {got}, seams {spy}: want {expected} "
                                 "(2 x jobs (+ device share generations), one bit-plane "
                                 "launch a device erasure product) and no host fold")
        if er["native"]["calls"] or er["numpy"]["calls"] or not er["device"]["calls"]:
            raise AssertionError(f"{what}: erasure products {er}")
        rec.update({
            "launches": got, "seams": spy, "erasure": er,
            "jobs_per_verify_call": spy["jobs"] / spy["verify_calls"],
            "ms_per_fold": 1e3 * spy["fold_s"] / spy["folds"],
            "erasure_device_bytes_per_s": er["device"]["bytes"] / spy["product_s"]
            if spy["product_s"] else None,
        })
        out[name] = rec
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    ctx["netsim_launches"] = launches
    ctx["netsim_folds"] = out["classic"]["seams"]["folds"] + out["vid"]["seams"]["folds"]
    return out


EDGE_N = 22
EDGE_SEED = 0
EDGE_BATCH = 64
EDGE_DEPTH = 2
EDGE_DEVICE = "cuda"
EDGE_MAX_TX_BYTES = NETSIM_MAX_TX_BYTES
EDGE_GATEWAY_LINKS = 2
# the open-loop load through the gateway: 250-byte distinct transactions (the
# HoneyBadgerBFT paper's size), 16 clients in waves of 16, 64 tx/s offered
# for 15 s (cut from 30 s for the script's time limit: the post-mortem
# decodes every journaled message); after the window the generator waits up
# to 30 s for commits (its report needs one, and the first epochs commit
# tens of seconds into the load)
EDGE_TX_BYTES = 250
EDGE_CLIENTS = 16
EDGE_WAVE = 16
EDGE_RATE = 64.0
EDGE_WINDOW_S = 15.0
EDGE_DRAIN_S = 30.0
EDGE_BOOT_S = 240.0      # every node's /status answering, the gateway's links up
EDGE_SETTLE_S = 120.0    # after loadgen: every admitted transaction on every node
EDGE_WATCH_INTERVAL_S = 1.0
# the longest a poll tick may take: its sleep, then a scrape bounded by its
# socket timeout plus 1 s of grace (Watchtower.scrape)
EDGE_SCRAPE_TIMEOUT_S = 2.0
EDGE_WATCH_TICK_S = EDGE_WATCH_INTERVAL_S + EDGE_SCRAPE_TIMEOUT_S + 1.0
EDGE_TAIL_S = 240.0      # after the nodes stop: the journal tail has fed every record
# netsim's slower pings and longer dead window, not the defaults' 0.5 s and
# 3 s: under this load a node process's event loop stalls for up to ~5 s, so
# at the defaults links die and redial by the hundred, and a redial torn
# mid-handshake is journaled as an auth failure that the watchtower raises
EDGE_HEARTBEAT_S = NETSIM_HEARTBEAT_S
EDGE_DEAD_AFTER_S = NETSIM_DEAD_AFTER_S


def _edge_node(out_path: str, argv) -> int:
    """Child mode of ``edge22``: ``chip_smoke.py --edge-node OUT NODE-ARGS``
    runs one node as ``python -m hbbft_tpu_torch.net.cluster NODE-ARGS``
    would, under ``netsim``'s spies, and when the node stops writes to OUT
    its kernel launches, seam counts, erasure products, pump segments, event
    loop lag and devices.  Spies in the parent cannot see a child's
    launches."""
    sys.path.insert(0, HERE)
    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.net import cluster
    from hbbft_tpu_torch.ops import rs

    rec = {"pid": os.getpid(), "cuda_available": torch.cuda.is_available()}
    held, lags, stalls = {}, [], []
    build_runtime = cluster.build_runtime

    async def loop_lag():  # how late a 50 ms sleep wakes: this node's loop stalls
        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.05)
            lags.append(time.perf_counter() - t - 0.05)
            if lags[-1] > 1.0 and len(stalls) < 16:  # when, by the wall clock
                stalls.append([time.time(), lags[-1]])

    def spy_build_runtime(cfg, infos, nid, *args, **kw):
        rt = build_runtime(cfg, infos, nid, *args, **kw)
        held["rt"] = rt
        held["lag"] = asyncio.ensure_future(loop_lag())
        rec.update(node=nid, device=str(cfg.device),
                   stack_device=str(rt.sq.algo.dhb.hb.device))
        return rt

    cluster.build_runtime = spy_build_runtime
    warm_device = cluster.warm_device

    def spy_warm_device(cfg):
        """The node's device warm-up runs before it serves; its launch and
        product are not the node's work, and are left out of the record."""
        warm_device(cfg)
        _build.reset_launches()
        held["stats0"] = rs.stats_snapshot()
        held["spy"].update(products=0, product_s=0.0, first_product_at=None)

    cluster.warm_device = spy_warm_device
    held["stats0"] = rs.stats_snapshot()
    with _netsim_spies(B, rs) as spy:
        held["spy"] = spy
        try:
            cluster.main(argv)
        finally:
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            stats1 = rs.stats_snapshot()
            rt = held.get("rt")
            rec.update({
                "launches": dict(_build.LAUNCHES),
                "seams": {**spy, "devices": sorted(spy["devices"])},
                "erasure": {b: {k: stats1[b][k] - held["stats0"][b][k] for k in stats1[b]}
                            for b in stats1},
                "loop_lag_s": {"p50": statistics.median(lags) if lags else None,
                               "max": max(lags, default=None), "samples": len(lags)},
                "stalls_over_1s": stalls,
            })
            if rt is not None:
                rec["pump_segment_s"] = {k: rt._pump_seg[k].sum for k in NETSIM_SEGMENTS}
                rec["pump_iterations"] = rt.pump.iterations
                rec["batches"] = len(rt.batches)
            with open(out_path + ".tmp", "w") as fh:
                json.dump(rec, fh)
            os.replace(out_path + ".tmp", out_path)
    return 0


@contextlib.contextmanager
def _edge_node_commands(cluster, stats_dir: str):
    """``spawn_node`` builds its command with ``cluster.node_command``: while
    the block runs, that command runs this file's ``--edge-node`` child mode
    with the same node arguments."""
    node_command = cluster.node_command

    def command(cfg, nid):
        cmd = node_command(cfg, nid)
        if cmd[1:3] != ["-m", "hbbft_tpu_torch.net.cluster"]:
            raise AssertionError(f"edge22: unexpected node command {cmd}")
        return [cmd[0], os.path.join(HERE, "chip_smoke.py"), "--edge-node",
                os.path.join(stats_dir, f"node-{nid}.json"), *cmd[3:]]

    cluster.node_command = command
    try:
        yield
    finally:
        cluster.node_command = node_command


def _edge_journals(flight_root: str):
    """Per node, how often each transaction's trace id was journaled as
    committed (``FlightTrace`` ``commit`` records); and the records a
    journal tail feeds its auditor (every one but the segments'
    ``FlightHello``s) and the journals' bytes."""
    from hbbft_tpu_torch.obs.flight import FlightHello, find_journal_dirs, read_journal
    from hbbft_tpu_torch.obs.trace import FlightTrace, iter_tids

    out, records, size = {}, 0, 0
    for d in find_journal_dirs(flight_root):
        j = read_journal(d)
        size += sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        counts = {}
        for _inc, r in j.records:
            if isinstance(r, FlightTrace) and r.stage == "commit":
                for tid in iter_tids(r.tids):
                    counts[tid] = counts.get(tid, 0) + 1
            records += not isinstance(r, FlightHello)
        out[j.node] = counts
    return out, records, size


def _ephemeral_ports():
    """The kernel's local port range for outgoing connections, where it
    says (a run's fixed ports may lie inside it)."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as fh:
            return [int(x) for x in fh.read().split()]
    except (OSError, ValueError):
        return None


def _edge_statuses(cfg):
    from hbbft_tpu_torch.obs.http import http_get

    return [json.loads(http_get(*cfg.metrics_addr(i), "/status", timeout_s=5.0))
            for i in range(cfg.n)]


async def _edge_wait(what: str, cond, timeout_s: float, poll_s: float = 0.5):
    """Poll ``cond`` (run in a thread; OSError counts as not yet) until it
    returns a true value, at most ``timeout_s``."""
    t0 = time.perf_counter()
    while True:
        try:
            got = await asyncio.to_thread(cond)
        except OSError:
            got = None
        if got:
            return got
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"edge22: {what} not reached in {timeout_s:.0f} s")
        await asyncio.sleep(poll_s)


def _edge_cli(args, out_path: str, timeout_s: float = 300.0):
    """One ``python -m hbbft_tpu_torch.<module>`` run with its stdout kept in
    ``out_path``; returns (exit code, stdout)."""
    with open(out_path, "w") as fh:
        proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE, stdout=fh,
                              timeout=timeout_s)
    with open(out_path) as fh:
        return proc.returncode, fh.read()


def _edge_keep_journals(flight_root: str, path: str) -> None:
    """The first segment of every journal under ``flight_root``, as a
    gzipped tar at ``path``: a prefix of the whole set that fits beside a
    run's output."""
    import tarfile

    from hbbft_tpu_torch.obs.flight import find_journal_dirs

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with tarfile.open(path, "w:gz") as tar:
        for d in find_journal_dirs(flight_root):
            first = min(f for f in os.listdir(d) if f.endswith(".fjl"))
            tar.add(os.path.join(d, first), os.path.join(os.path.basename(d), first))


def _edge_watch_start(root: str, name: str, port: int, args):
    """A ``python -m hbbft_tpu_torch.obs.watch ARGS`` process ticking every
    EDGE_WATCH_INTERVAL_S, serving its ``/health`` on ``port``, its
    incidents (JSONL) and log kept in ``root`` under ``name``."""
    paths = [os.path.join(root, f"{name}.{ext}") for ext in ("jsonl", "log")]
    with open(paths[0], "w") as out, open(paths[1], "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "hbbft_tpu_torch.obs.watch", *args, "--json",
             "--interval", str(EDGE_WATCH_INTERVAL_S), "--serve-port", str(port)],
            cwd=HERE, stdout=out, stderr=log)
    return proc, paths


def _edge_watch_stop(proc, paths) -> dict:
    """Interrupt a watchtower; its exit code, incidents and the ticks its
    summary line counts (the last of them may have been cut short)."""
    proc.send_signal(signal.SIGINT)
    proc.wait(timeout=60)
    with open(paths[0]) as fh:
        incidents = [json.loads(ln) for ln in fh if ln.strip()]
    with open(paths[1]) as fh:
        summary = fh.read().strip().splitlines()[-1:]
    ticks = re.search(r"over (\d+) ticks", summary[0]) if summary else None
    return {"rc": proc.returncode, "incidents": incidents, "summary": summary,
            "ticks": int(ticks.group(1)) if ticks else 0}


def _edge_health(addr, tries: int = 1):
    """A watchtower's ``/health``, or None while it does not answer in
    ``tries`` attempts (on the journal tail's process the server thread's
    derivation can race the poll feeding it)."""
    import http.client

    from hbbft_tpu_torch.obs.http import http_get

    for attempt in range(tries):
        try:
            return json.loads(http_get(*addr, "/health", timeout_s=10.0))
        except (OSError, ValueError, http.client.HTTPException):
            if attempt + 1 < tries:
                time.sleep(1.0)
    return None


def _edge_tail(addr, watcher, records: int) -> dict:
    """Wait, at most EDGE_TAIL_S, until the journal-tail watchtower at
    ``addr`` has fed its auditor ``records`` records and finished the tick
    that fed the last of them, incident extraction included (its next tick
    has begun); then interrupt it."""
    t0 = time.perf_counter()
    doc, fed_in, first = None, None, None
    while time.perf_counter() - t0 < EDGE_TAIL_S and watcher[0].poll() is None:
        doc = _edge_health(addr) or doc
        if doc is not None and first is None:  # how far behind the tail was
            first = {"s": time.perf_counter() - t0, "records": doc["audit"]["records"]}
        if doc is not None and fed_in is None and doc["audit"]["records"] >= records:
            fed_in = doc["ticks"]
        if fed_in is not None and doc["ticks"] > fed_in:
            break
        time.sleep(2.0)
    out = _edge_watch_stop(*watcher)
    out.update(catch_up_s=time.perf_counter() - t0, first_answer=first,
               records=doc and doc["audit"]["records"],
               verdict=doc and doc["audit"]["verdict"],
               evaluated=fed_in is not None and doc["ticks"] > fed_in)
    return out


def edge_deployment(root: str, n: int = EDGE_N, device: str = EDGE_DEVICE,
                    window_s: float = EDGE_WINDOW_S, rate: float = EDGE_RATE,
                    clients: int = EDGE_CLIENTS, smi: str = "", keep: str = "") -> dict:
    """``edge22`` (a)–(c): ``n`` node processes started by the port's
    launcher, one gateway process, open-loop load through it with two
    watchtowers (the SLO poll, the journal tail) and ``obs.top`` looking
    on, then the post-mortem on the journals while the tail catches up.
    With ``keep``, the first segment of every node's journal is written to
    ``keep/edge22-journals.tgz``.  Every gate raises; returns the record."""
    watchers = {}
    try:
        return _edge_deployment(root, watchers, n, device, window_s, rate, clients, smi, keep)
    finally:
        for proc, _paths in watchers.values():
            proc.kill()
            proc.wait()


def _edge_deployment(root, watchers, n, device, window_s, rate, clients, smi, keep) -> dict:
    from hbbft_tpu_torch import cluster_launch
    from hbbft_tpu_torch.net import cluster, loadgen
    from hbbft_tpu_torch.obs.http import http_get
    from hbbft_tpu_torch.obs.trace import trace_id

    flight, stats = os.path.join(root, "flight"), os.path.join(root, "stats")
    os.makedirs(stats)
    base = cluster.find_free_base_port(2 * n + 3)
    gw_metrics = base + 2 * n
    slo_addr, tail_addr = ("127.0.0.1", base + 2 * n + 1), ("127.0.0.1", base + 2 * n + 2)
    cfg = cluster_launch.build_config(cluster_launch.parse_args([
        "--nodes", str(n), "--seed", str(EDGE_SEED), "--batch-size", str(EDGE_BATCH),
        "--max-tx-bytes", str(EDGE_MAX_TX_BYTES), "--base-port", str(base),
        "--flight-dir", flight, "--encrypt", "--pipeline-depth", str(EDGE_DEPTH),
        "--heartbeat-s", str(EDGE_HEARTBEAT_S), "--dead-after-s", str(EDGE_DEAD_AFTER_S),
        "--device", device]))
    rec = {"smi": smi, "n": n, "device": device, "batch_size": EDGE_BATCH,
           "pipeline_depth": EDGE_DEPTH,
           "heartbeat_s": cfg.heartbeat_s, "dead_after_s": cfg.dead_after_s,
           "host_cpus": os.cpu_count(), "ephemeral_ports": _ephemeral_ports(),
           "seconds": {}}
    shape = loadgen.LoadShape(tx_bytes=EDGE_TX_BYTES, clients=clients, wave_txs=EDGE_WAVE,
                              rate_tx_s=rate, duration_s=window_s, drain_s=EDGE_DRAIN_S)
    rec["load"] = {k: getattr(shape, k) for k in ("tx_bytes", "clients", "wave_txs",
                                                  "rate_tx_s", "duration_s", "drain_s")}
    node_targets = ",".join("%s:%d" % cfg.metrics_addr(i) for i in range(n))
    procs, gw_procs = {}, []
    log_path = os.path.join(root, "nodes.log")
    t_phase = time.perf_counter()
    gw_target = ("127.0.0.1", gw_metrics)
    try:
        # the gateway's and the watchtowers' fixed ports stay held from
        # before the nodes dial until each has its listener (a node's dial
        # could otherwise take one as its local port)
        with cluster.hold_ports("127.0.0.1", [gw_metrics, slo_addr[1], tail_addr[1]]):
            with open(log_path, "w") as log, _edge_node_commands(cluster, stats), \
                    contextlib.redirect_stdout(sys.stderr):
                procs = cluster_launch.launch(cfg, stdout=log, stderr=subprocess.STDOUT)
            rec["seconds"]["spawn"] = time.perf_counter() - t_phase
            # the gateway prints its address once its obs port is bound
            gw_procs, gw_addrs = loadgen.spawn_gateways(
                cfg, 1, node_links=EDGE_GATEWAY_LINKS, metrics_base_port=gw_metrics)
            # the live view, two watchtowers, so that the poll never waits
            # behind the tail: one polls every node and the gateway once a
            # second (the SLO rules), one tails the journals through the
            # streaming auditor
            watchers["slo"] = _edge_watch_start(
                root, "watch-slo", slo_addr[1],
                ["--targets", node_targets, "--gateways", "%s:%d" % gw_target,
                 "--scrape-timeout", str(EDGE_SCRAPE_TIMEOUT_S)])
            watchers["tail"] = _edge_watch_start(root, "watch-tail", tail_addr[1],
                                                 ["--journals", flight])
            cluster.wait_listening([slo_addr, tail_addr],
                                   [watchers["slo"][0], watchers["tail"][0]], EDGE_BOOT_S)

        async def session():
            t0 = time.perf_counter()
            await _edge_wait("every node's /status", lambda: _edge_statuses(cfg), EDGE_BOOT_S)
            await _edge_wait("the gateway's node links", lambda: sum(
                1 for li in json.loads(http_get(*gw_target, "/status"))["links"]
                if li["connected"]) == EDGE_GATEWAY_LINKS, EDGE_BOOT_S)
            rec["seconds"]["boot"] = time.perf_counter() - t0
            gen = loadgen.LoadGenerator(gw_addrs, cfg.cluster_id, shape)
            t1 = time.perf_counter()
            rec["load_started_at"] = time.time()
            load = asyncio.ensure_future(gen.run())
            await asyncio.sleep(window_s / 2)
            t_top = time.perf_counter()  # one GET at a time, each waiting on a busy loop

            async def top():
                out = await asyncio.to_thread(
                    _edge_cli, ["hbbft_tpu_torch.obs.top", "--json", "--targets", node_targets,
                                "--gateways", "%s:%d" % gw_target],
                    os.path.join(root, "top.json"), 240.0)
                rec["seconds"]["top"] = time.perf_counter() - t_top
                return out

            # the snapshot, taken under load, finishes while the cluster settles
            top_task = asyncio.ensure_future(top())
            report = await load
            rec["seconds"]["load"] = time.perf_counter() - t1
            admitted = json.loads(http_get(*gw_target, "/status"))["submissions"]["accepted"]
            t2 = time.perf_counter()

            def settled():
                docs = _edge_statuses(cfg)
                heads = {(d["chain_len"], d["digest_chain"][-1] if d["digest_chain"] else "")
                         for d in docs}
                if len(heads) == 1 and all(d["committed_txs"] >= admitted for d in docs):
                    return docs
                return None

            docs = await _edge_wait("every admitted transaction on every node, one chain head",
                                    settled, EDGE_SETTLE_S)
            rec["seconds"]["settle"] = time.perf_counter() - t2
            rec["wall_to_last_commit_s"] = time.perf_counter() - t1
            gw_doc = json.loads(http_get(*gw_target, "/status"))
            snap = await top_task
            return gen, report, snap, docs, gw_doc

        gen, report, snap, docs, gw_doc = asyncio.run(session())
        slo_doc = _edge_health(slo_addr, tries=3)
        rec["watch"] = {"slo": {**_edge_watch_stop(*watchers.pop("slo")),
                                "targets_up": slo_doc and slo_doc["targets_up"]}}
        rc, out = snap
        snapshot = json.loads(out)
        rec["top"] = {"rc": rc, "node_rows": len(snapshot["nodes"]),
                      "nodes_up": sum(1 for d in snapshot["nodes"] if d["up"]),
                      "gateway_rows": len(snapshot.get("gateways", []))}
        rec["loadgen"] = {k: report[k] for k in (
            "offered_txs", "submitted_txs", "shed_txs", "local_drops", "ack_timeouts",
            "committed_txs", "wall_s", "tx_per_s", "p50_ms", "p99_ms")}
        rec["gateway"] = {k: gw_doc[k] for k in ("submissions", "forwarded", "commits_relayed",
                                                 "sheds", "link_failovers")}
        admitted = gw_doc["submissions"]["accepted"]
        rec["admitted"] = admitted
        rec["tx_per_s"] = admitted / rec["wall_to_last_commit_s"]
        rec["status"] = {k: sorted({d[k] for d in docs}) for k in
                         ("committed_txs", "decode_failures", "peers_connected", "batches")}
        rec["dead_peer_events"] = sum(d["stats"]["dead_peer_events"] for d in docs)
        auth = {}
        for d in docs:
            for reason, v in d["guard"]["ingress"]["auth_failures"].items():
                auth[reason] = auth.get(reason, 0) + v
        rec["auth_failures"] = auth
        rec["reconnects"] = sum(sum(d["stats"]["reconnects"].values()) for d in docs)
        offered = {trace_id(tx) for c in range(shape.clients)
                   for w in range(report["offered_txs"] // shape.wave_txs + 1)
                   for tx in gen._make_wave(c, w)}
    except BaseException:
        with open(log_path) as fh:
            sys.stderr.write("edge22: the node processes' log, last 8 KB:\n" + fh.read()[-8192:])
        raise
    finally:
        t_stop = time.perf_counter()
        cluster.shutdown_procs(gw_procs)
        cluster.shutdown_procs(procs.values())
        rec["seconds"]["stop"] = time.perf_counter() - t_stop
    codes = {i: p.returncode for i, p in procs.items()}
    # the children's own records
    kids = {}
    for i in range(n):
        path = os.path.join(stats, f"node-{i}.json")
        if not os.path.exists(path):
            raise AssertionError(f"edge22: node {i} wrote no record (exit {codes[i]})")
        with open(path) as fh:
            kids[i] = json.load(fh)
    rec["exit_codes"] = sorted(set(codes.values()))
    # (c) the post-mortem on the journals, through the CLIs, side by side
    # with this process's own count of the journaled commits
    t3 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        audit_run = pool.submit(_edge_cli, ["hbbft_tpu_torch.obs.audit", flight, "--json"],
                                os.path.join(root, "audit.json"))
        cp_run = pool.submit(_edge_cli, ["hbbft_tpu_torch.obs.critpath", flight, "--json",
                                         "--waterfalls", str(10 ** 9)],
                             os.path.join(root, "critpath.json"))
        commits, journal_records, journal_bytes = _edge_journals(flight)
        rec["watch"]["tail"] = _edge_tail(tail_addr, watchers.pop("tail"), journal_records)
        (audit_rc, audit_out), (cp_rc, cp_out) = audit_run.result(), cp_run.result()
    audit, cp = json.loads(audit_out), json.loads(cp_out)
    rec["seconds"]["post_mortem"] = time.perf_counter() - t3
    rec["journals"] = {"records": journal_records, "bytes": journal_bytes}
    if keep:
        _edge_keep_journals(flight, os.path.join(keep, "edge22-journals.tgz"))
    heads = {c["head"] for c in audit["chains"].values()}
    rec["audit"] = {"rc": audit_rc, "verdict": audit["verdict"], "chains": len(audit["chains"]),
                    "heads": len(heads), "chain_len": sorted({c["len"] for c in
                                                              audit["chains"].values()}),
                    "torn_tails": audit["torn_tails"],
                    "unmatched_receives": audit["unmatched_receives"]}
    sums = [abs(sum(r["components"].values()) - r["total_s"]) for r in cp["waterfalls"]]
    widths = [d["bound_s"] for d in cp["clock_offsets"].values() if d["bound_s"] is not None]
    rec["critpath"] = {
        "rc": cp_rc, "txs_committed": cp["txs_committed"],
        "txs_reconstructed": cp["txs_reconstructed"],
        "max_component_sum_error_s": max(sums, default=None),
        "p50": cp.get("p50"), "p99": cp.get("p99"),
        "clock_offset_bound_s": {"min": min(widths, default=None),
                                 "median": statistics.median(widths) if widths else None,
                                 "max": max(widths, default=None),
                                 "unaligned": cp["unmatched"]["unaligned_processes"]},
    }
    # the children's device work, summed
    launches = {}
    for k in kids.values():
        for name, v in k["launches"].items():
            launches[name] = launches.get(name, 0) + v
    seams = {key: sum(k["seams"][key] for k in kids.values()) for key in
             ("verify_calls", "jobs", "folds", "host_folds", "share_gens", "host_share_gens",
              "products", "fold_s", "verify_s", "product_s")}
    erasure = {b: {key: sum(k["erasure"][b][key] for k in kids.values())
                   for key in kids[0]["erasure"][b]} for b in kids[0]["erasure"]}
    ms_fold = [1e3 * k["seams"]["fold_s"] / k["seams"]["folds"]
               for k in kids.values() if k["seams"]["folds"]]
    lag_max = [k["loop_lag_s"]["max"] for k in kids.values() if k["loop_lag_s"]["max"] is not None]
    rec.update({
        "launches": launches, "seams": seams, "erasure": erasure,
        "jobs_per_verify_call": seams["jobs"] / seams["verify_calls"] if seams["verify_calls"] else None,
        "ms_per_fold_by_process": {"min": min(ms_fold, default=None),
                                   "median": statistics.median(ms_fold) if ms_fold else None,
                                   "max": max(ms_fold, default=None)},
        "pump_segment_s": {s: sum(k.get("pump_segment_s", {}).get(s, 0.0) for k in kids.values())
                           for s in NETSIM_SEGMENTS},
        "loop_lag_s": {"max_by_process_median": statistics.median(lag_max) if lag_max else None,
                       "max": max(lag_max, default=None)},
        # wall-clock starts (and seconds) of each process's stalls over 1 s
        # and of its first device fold and erasure product
        "stalls_by_process": {i: {"stalls": k.get("stalls_over_1s"),
                                  "first_fold": k["seams"].get("first_fold_at"),
                                  "first_product": k["seams"].get("first_product_at")}
                              for i, k in kids.items()},
        "children": {"cuda_available": sorted({k["cuda_available"] for k in kids.values()}),
                     "device": sorted({k.get("device") for k in kids.values()}),
                     "stack_device": sorted({k.get("stack_device") for k in kids.values()}),
                     "seam_devices": sorted({d for k in kids.values()
                                             for d in k["seams"]["devices"]})},
    })
    rec["seconds"]["phase"] = time.perf_counter() - t_phase
    # the gates
    on_card = device != "cpu"
    want_dev = ["cuda"] if on_card else ["cpu"]
    expected = 2 * seams["jobs"] + seams["share_gens"]
    gates = {
        # under load and settling, the poll finished a tick at least every
        # EDGE_WATCH_TICK_S (the last tick counted may have been cut short)
        "the SLO watchtower: polls of every node and the gateway, no incident": (
            rec["watch"]["slo"]["ticks"] - 1
            >= (rec["seconds"]["load"] + rec["seconds"]["settle"]) / EDGE_WATCH_TICK_S
            and rec["watch"]["slo"]["targets_up"] == n + 1
            and not rec["watch"]["slo"]["incidents"] and not rec["watch"]["slo"]["rc"]),
        "the journal tail: every record fed and evaluated, clean, no incident": (
            rec["watch"]["tail"]["records"] == journal_records
            and rec["watch"]["tail"]["evaluated"] and rec["watch"]["tail"]["verdict"] == "clean"
            and not rec["watch"]["tail"]["incidents"] and not rec["watch"]["tail"]["rc"]),
        "obs.top: every node up and a gateway row": (
            rec["top"]["node_rows"] == n and rec["top"]["nodes_up"] == n
            and rec["top"]["gateway_rows"] == 1 and not rec["top"]["rc"]),
        "the gateway admitted transactions and nothing was shed": (
            admitted > 0 and not rec["gateway"]["sheds"] and not report["shed_txs"]),
        "every admitted transaction journaled as committed once on every node": (
            len(commits) == n and all(
                len(c) == admitted and set(c.values()) == {1} and not set(c) - offered
                for c in commits.values())),
        "the audit clean with every chain and one head": (
            audit["verdict"] == "clean" and not audit_rc and len(audit["chains"]) == n
            and len(heads) == 1),
        "critpath's components sum to each total": (
            not cp_rc and cp["txs_reconstructed"] > 0
            and rec["critpath"]["max_component_sum_error_s"] < 1e-6),
        "0 decode failures and every peer on every /status": (
            rec["status"]["decode_failures"] == [0]
            and rec["status"]["peers_connected"] == [n - 1]),
        "every node process exited 0": rec["exit_codes"] == [0],
        "every node process on the card": (
            rec["children"]["cuda_available"] == [on_card]
            and rec["children"]["device"] == want_dev
            and [d.split(":")[0] for d in rec["children"]["stack_device"]] == want_dev
            and rec["children"]["seam_devices"] == want_dev),
        "ladder_window = 2 x merged jobs, bitplane = erasure products, no host fold, "
        "no other launch": not on_card or (
            seams["jobs"] > 0 and not seams["host_folds"] and seams["folds"] == 2 * seams["jobs"]
            and launches.get("ladder_window") == expected
            and launches.get("bitplane") == erasure["device"]["calls"]
            and not any(v for k, v in launches.items() if k not in ("ladder_window", "bitplane"))),
        "every erasure product on the card": (
            not erasure["native"]["calls"] and not erasure["numpy"]["calls"]
            and erasure["device"]["calls"] > 0),
    }
    rec["journal_commits"] = {"nodes": len(commits),
                              "per_node": sorted({len(c) for c in commits.values()}),
                              "more_than_once": sum(1 for c in commits.values()
                                                    for v in c.values() if v != 1),
                              "never_offered": sum(len(set(c) - offered)
                                                   for c in commits.values())}
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        with open(log_path) as fh:
            notes = [ln for ln in fh if "guard:" in ln or "Error" in ln]
        sys.stderr.write("edge22: the record\n" + json.dumps(rec, default=str)[:20000]
                         + "\nedge22: the nodes' guard and error lines (first 60)\n"
                         + "".join(notes[:60]))
        raise AssertionError(f"edge22: gates failed: {failed}")
    return rec


EDGE_SOCKET_CELLS = ("garbage-stream", "spoof-nokey")


def edge_campaign(root: str, device: str = EDGE_DEVICE) -> dict:
    """``edge22`` (d): the campaign on ``device`` at the reference's own cell
    sizes: ``smoke_grid()``, the equivocator under loss, and one socket cell
    each of ``garbage-stream`` and ``spoof-nokey``.  Gates as listed in the
    module docstring; returns the record."""
    from hbbft_tpu_torch.chaos import campaign as C

    what = "edge22 (campaign)"
    rec = {"seconds": {}}
    t0 = time.perf_counter()
    smoke = C.run_campaign(C.smoke_grid(), os.path.join(root, "smoke"), device=device)
    rec["seconds"]["smoke"] = time.perf_counter() - t0
    rec["smoke"] = {"verdicts": smoke["verdicts"], "errors": smoke["errors"],
                    "stalled": smoke["stalled_cells"],
                    "batches_min": [d.get("batches_min") for d in smoke["cells_detail"]]}
    if smoke["verdicts"] != {"clean": len(C.smoke_grid())} or smoke["stalled_cells"]:
        raise AssertionError(f"{what}: smoke grid {rec['smoke']}, triage {smoke['triage']}")
    t0 = time.perf_counter()
    spec = C.CellSpec(shape="lossy-1pct", adversary="equivocate", seed=0, crank_limit=60_000)
    equiv = C.run_campaign([spec], os.path.join(root, "equivocate"), verify_nonclean=False,
                           device=device)
    rec["seconds"]["equivocate"] = time.perf_counter() - t0
    tri = equiv["triage"]
    rec["equivocate"] = {"verdicts": equiv["verdicts"],
                         "triage": [{k: t[k] for k in ("faulty_nodes", "first_divergent_epoch",
                                                       "kinds")} for t in tri]}
    if equiv["verdicts"] != {"fault": 1} or len(tri) != 1 or tri[0]["faulty_nodes"] != ["3"] \
            or tri[0]["first_divergent_epoch"] is None \
            or C.CellSpec.from_dict(tri[0]["replay"]["spec"]) != spec:
        raise AssertionError(f"{what}: equivocator under loss {rec['equivocate']}")
    for adv in EDGE_SOCKET_CELLS:
        t0 = time.perf_counter()
        spec = C.CellSpec(kind="socket", shape="none", adversary=adv, n=4, seed=0,
                          pipeline_depth=2)
        detail, res = C.run_socket_cell(spec, os.path.join(root, adv), device=device)
        rec["seconds"][adv] = time.perf_counter() - t0
        guard = detail.get("guard", {})
        cell = {"verdict": detail["verdict"], "batches_min": detail["batches_min"],
                "commit_wall_s": detail["commit_wall_s"],
                "attributed_to": detail.get("overload_attributed_to"),
                "injector": guard.get("injector"),
                "watch_incidents": (detail.get("watch") or {}).get("incidents")}
        if adv.startswith("spoof-"):
            cell.update(auth_refused=guard.get("auth_refused"),
                        impersonated_peer_doc=guard.get("impersonated_peer_doc"))
        rec[adv] = cell
        ok = detail["verdict"] == "clean" and detail["batches_min"] >= 1
        if adv == "garbage-stream":
            ok = ok and guard["injector"]["frames_sent"] > 0 \
                and detail["overload_attributed_to"] == ["3"]
        else:
            inj = guard["injector"]
            attributed = detail["overload_attributed_to"]
            ok = ok and inj["attempts"] > 0 and inj["hellos_accepted"] == 0 \
                and guard["auth_refused"] >= inj["attempts"] \
                and not guard["impersonated_peer_doc"].get("strikes") \
                and not guard["impersonated_peer_doc"].get("decode_fails") \
                and attributed and "3" not in attributed \
                and all(":" in a for a in attributed)
        if not ok:
            raise AssertionError(f"{what}: socket cell {adv}: {cell}")
    return rec


def phase_edge22(ctx):
    """The operator's edge on the card: 22 node processes behind a gateway
    under open-loop load, the live view, the post-mortem, and the campaign
    (module docstring, phase 25)."""
    import tempfile

    import torch

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.ops import rs

    out = {"smi": ctx["smi"]}
    with tempfile.TemporaryDirectory() as root, _erasure_backend("device"):
        out["deployment"] = edge_deployment(os.path.join(root, "deployment"), smi=ctx["smi"],
                                            keep=ctx["keep_journals"])
        torch.cuda.synchronize()
        _build.reset_launches()
        products = rs.stats_snapshot()["device"]["calls"]
        out["campaign"] = edge_campaign(os.path.join(root, "campaign"))
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        products = rs.stats_snapshot()["device"]["calls"] - products
    # this process's cells: one bit-plane launch a device erasure product,
    # no other launch (encryption is off in every cell)
    if launches != {**{k: 0 for k in launches}, "bitplane": products}:
        raise AssertionError(f"edge22 (campaign): launches {launches}, "
                             f"{products} device erasure products")
    out["campaign"].update(launches=launches, device_erasure_products=products)
    ctx["edge22_launches"] = out["deployment"]["launches"]
    ctx["edge22_folds"] = out["deployment"]["seams"]["folds"]
    ctx["campaign_launches"] = out["campaign"]["launches"]
    return out


def _mesh_epoch64(torch, mesh, nets, contribs):
    """The N = 64 epoch sharded over ``mesh`` and unsharded, on the same
    inputs: (sharded seconds by phase, unsharded ones, launches of the
    timed sharded run)."""
    import numpy as np

    from hbbft_tpu_torch import _build
    from hbbft_tpu_torch.parallel.acs import BatchedHoneyBadgerEpoch

    one = BatchedHoneyBadgerEpoch(nets, device="cuda", encrypt_backend="device")
    sharded = BatchedHoneyBadgerEpoch(nets, encrypt_backend="device", mesh=mesh)
    for ep in (sharded, one):  # warm: first use of each path
        ep.run(contribs, random.Random(13))

    def timed(ep):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        payloads = ep.encrypt_phase(contribs, random.Random(14))
        t_enc = time.perf_counter() - t0
        batch, detail = ep.run_from_payloads(payloads, timer=time.perf_counter)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        secs = {"epoch_s": time.perf_counter() - t0, "encrypt_s": t_enc, **detail["phase_s"]}
        return payloads, batch, detail, secs, launches

    pay_m, batch_m, det_m, secs_m, launches = timed(sharded)
    pay_s, batch_s, det_s, secs_s, _ = timed(one)
    if pay_m != pay_s:
        raise AssertionError("mesh epoch: the ciphertext bytes differ from the unsharded epoch's")
    if not (batch_m == batch_s == contribs):
        raise AssertionError("mesh epoch: the batch differs from the unsharded epoch's")
    if not np.array_equal(det_m["accepted"], det_s["accepted"]) or det_m["epochs"] != det_s["epochs"]:
        raise AssertionError("mesh epoch: accepted or ABA epochs differ from the unsharded epoch's")
    # the sharded round encodes once, then decodes and re-encodes once a
    # receiver chunk (mesh.RECEIVER_CHUNK_BYTES of shards at a time)
    from hbbft_tpu_torch.parallel.mesh import RECEIVER_CHUNK_BYTES

    B = shard_bytes(CIPHERTEXT_BYTES, N_NODES - 2 * 21)
    per_chunk = max(1, RECEIVER_CHUNK_BYTES // (N_NODES * N_NODES * B))
    bitplane = 1 + 2 * -(-N_NODES // per_chunk)
    if launches["ladder_window"] != 2 or launches["sha3_256"] < 1 or \
            launches["bitplane"] != bitplane or launches["ladder_lazy"] or launches["fp_mul_lazy"]:
        raise AssertionError(f"mesh epoch launches {launches}, bitplane expected {bitplane}")
    return secs_m, secs_s, launches


def _mesh_rbc1024(torch, mesh):
    """``BatchedRbc(1024, 341)`` at rbc_large's shape through
    ``make_sharded_rbc_large_run`` and unsharded, clean and with data shards
    altered after the commit (the straggler decode and the sharded stage
    B): every result equal.  Each case runs unsharded once first (the
    straggler decode caches its survivor pattern's matrix), then sharded,
    unsharded, sharded, unsharded; returns each route's two seconds."""
    import numpy as np

    from hbbft_tpu_torch.parallel.mesh import make_sharded_rbc_large_run
    from hbbft_tpu_torch.parallel.rbc import BatchedRbc

    rbc = BatchedRbc(N_LARGE, F_LARGE)
    rng = np.random.default_rng(21)
    values = [rng.integers(0, 256, CIPHERTEXT_BYTES, dtype=np.uint8).tobytes()
              for _ in range(N_LARGE)]
    data = rbc.upload_framed(values, torch.device("cuda"))
    vt = torch.zeros((N_LARGE, N_LARGE, data.shape[-1]), dtype=torch.uint8, device=data.device)
    vt[5, 3, 0], vt[N_LARGE // 2, 0, 7] = 0xFF, 0x01
    routes = {"sharded": make_sharded_rbc_large_run(rbc, mesh), "unsharded": rbc.run}
    secs = {}
    for case, kw in (("clean", {}), ("data_shard_tamper", {"value_tamper": vt})):
        rbc.run(data, **kw)
        outs = {}
        for how in ("sharded", "unsharded") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs[how] = routes[how](data, **kw)
            torch.cuda.synchronize()
            secs.setdefault(f"{case}_{how}_s", []).append(time.perf_counter() - t0)
        for key, val in outs["unsharded"].items():
            if not np.array_equal(outs["sharded"][key], val):
                raise AssertionError(f"mesh rbc1024 {case}: {key} differs")
        if not outs["sharded"]["delivered"].all():
            raise AssertionError(f"mesh rbc1024 {case}: not every proposer delivered")
    return secs


def _mesh_coin256(mesh):
    """coin256's shares through ``make_sharded_coin_verify``: True on the
    honest shares, False with one share over another message; after a warm
    call each, 3 timed calls of the hook and of the unsharded
    ``batch_verify_sig_shares``, in turns."""
    from hbbft_tpu_torch.crypto import batch as B
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.parallel.mesh import make_sharded_coin_verify

    rng = random.Random(99)
    sks = tc.SecretKeySet.random(COIN_F, rng)
    pks = sks.public_keys()
    msg = b"coin-epoch-42"
    pairs = [(pks.public_key_share(i), sks.secret_key_share(i).sign(msg))
             for i in range(COIN_N)]
    forged, k = list(pairs), COIN_N // 15
    forged[k] = (pairs[k][0], sks.secret_key_share(k).sign(b"coin-epoch-43"))
    routes = {"sharded": make_sharded_coin_verify(mesh), "unsharded": B.batch_verify_sig_shares}
    if routes["sharded"](pairs, msg, rng) is not True or \
            routes["sharded"](forged, msg, rng) is not False:
        raise AssertionError("mesh coin256: wrong verdicts")
    routes["unsharded"](pairs, msg, rng)  # warm
    secs = {}
    for how in ("sharded", "unsharded") * 3:
        t0 = time.perf_counter()
        if routes[how](pairs, msg, rng) is not True:
            raise AssertionError(f"mesh coin256: the {how} verify failed")
        secs.setdefault(f"{how}_s", []).append(time.perf_counter() - t0)
    return {k: {"median": statistics.median(v), "runs": v} for k, v in secs.items()}


def phase_mesh(ctx):
    """The device mesh on the card: an NCCL world of one rank on cuda:0 (the
    machine's one card; NCCL refuses two ranks on one card), its process
    group destroyed at the end.  At world size 1 the collectives move
    nothing: this shows the mesh code runs on CUDA tensors under NCCL with
    the kernels, not a speed-up.  Then ``graft_entry.dryrun_multichip(1,
    quick=True)`` in a process of its own."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from hbbft_tpu_torch import graft_entry
    from hbbft_tpu_torch.parallel import mesh as mesh_mod

    nets, contribs = _epoch64_inputs()
    res = {"smi": ctx["smi"]}
    before = mesh_mod.stats_snapshot()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("nodes",))
            mesh2d = init_device_mesh("cuda", (1, 1), mesh_dim_names=("dcn", "ici"))
            secs_m, secs_s, launches = _mesh_epoch64(torch, mesh, nets, contribs)
            secs_2d, _, launches_2d = _mesh_epoch64(torch, mesh2d, nets, contribs)
            res["epoch64"] = {"n": N_NODES, "sharded_s": secs_m, "unsharded_s": secs_s,
                              "sharded_2d_s": secs_2d, "launches": launches,
                              "launches_2d": launches_2d, "equal": True}
            res["rbc1024"] = {"n": N_LARGE, "f": F_LARGE, **_mesh_rbc1024(torch, mesh),
                              "equal": True}
            res["coin256"] = {"n": COIN_N, "f": COIN_F, **_mesh_coin256(mesh)}
        finally:
            dist.destroy_process_group()
    stats = {ph: {k: v - before[ph][k] for k, v in d.items()}
             for ph, d in mesh_mod.stats_snapshot().items()}
    if not all(stats[ph]["collectives"] > 0 for ph in ("rbc", "aba", "coin", "decrypt")):
        raise AssertionError(f"mesh: a phase's counters did not move: {stats}")
    res["stats"] = stats
    ctx["mesh64_launches"] = launches
    t0 = time.perf_counter()
    record = graft_entry.dryrun_multichip(1, quick=True)  # prints its JSON line
    res["dryrun"] = {"seconds": time.perf_counter() - t0, "record": record}
    return res


def phase_kernels(ctx):
    fp_main = ctx["fp"]["rows"][256]
    sha = ctx["sha3"]["shapes"][ctx["sha3"]["main"]]
    sha_l = ctx["sha3"]["shapes"][ctx["sha3"]["main_n1024"]]
    sha_x = ctx["sha3"]["shapes"][ctx["sha3"]["main_n4096"]]
    lad = ctx["ladder"]
    launches, launches_l = ctx["launches"], ctx["launches_n1024"]
    launches_x, launches_s = ctx["launches_n4096"], ctx["launches_sustained4096"]
    launches_h = ctx["launches_n16384"]
    win = ctx["window"]
    bp = ctx["bitplane"]

    def plane(case):
        """A bit-plane case's times, bound and shape."""
        return {k: case.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "library_float32_matmul_ms", "library_int_mm",
                                         "share_of_bound", "bound_lop3_ms", "bound_int8_peak_ms",
                                         "share_of_lop3_bound", "share_of_int8_peak_bound",
                                         "device_ms_per_launch", "plan", "shape")}

    def window_sum(shapes):
        """The windowed kernel's timed ``(group, rows)`` shapes, summed."""
        got = [win[g][r] for g, r in shapes]
        bms, by = bound_ms(ctx, sum(x["bytes"] for x in got), ops_sum([x["ops"] for x in got]))
        plains = [x["plain_ms"] for x in got]
        return {"ms": sum(x["ms"] for x in got),
                "plain_ms": None if None in plains else sum(plains),
                "bound_ms": bms, "bound_by": by,
                "device_ms_per_launch": {f"{g}_{r}": x["device_ms_per_launch"]
                                         for (g, r), x in zip(shapes, got)},
                "event_ms_per_launch": {f"{g}_{r}": x["event_ms_per_launch"]
                                        for (g, r), x in zip(shapes, got)},
                "share_of_bound": bms / sum(x["event_ms_per_launch"] for x in got),
                "k": {f"{g}_{r}": x["k"] for (g, r), x in zip(shapes, got)},
                "shape": " + ".join(f"{g.upper()} {r} rows" for g, r in shapes)
                         + f", {LADDER_BITS} bits"}

    epoch_w = window_sum([("g1", 4 * N_NODES), ("g2", 2 * N_NODES)])
    mxu = ctx["mxu"]

    def mxu_sum(shapes):
        """The 8-bit field's kernel at its timed ``(group, rows)`` shapes,
        summed; ``plain_ms`` the plain calls of those groups (each over all
        of its group's cases)."""
        got = [mxu[g]["shapes"][r] for g, r in shapes]
        bms = sum(x["bound_ms"] for x in got)
        return {"ms": sum(x["ms"] for x in got),
                "plain_ms": sum(mxu[g]["plain_ms"] for g in {g for g, _ in shapes}),
                "plain_rows": sum(mxu[g]["plain_rows"] for g in {g for g, _ in shapes}),
                "bound_ms": bms, "bound_by": max(got, key=lambda x: x["bound_ms"])["bound_by"],
                "share_of_bound": bms / sum(x["event_ms_per_launch"] for x in got),
                "device_ms_per_launch": {f"{g}_{r}": x["device_ms_per_launch"]
                                         for (g, r), x in zip(shapes, got)},
                "ladder_window_ms": {f"{g}_{r}": x["ladder_window_ms"]
                                     for (g, r), x in zip(shapes, got)},
                "shape": " + ".join(f"{g.upper()} {r} rows" for g, r in shapes)
                         + f", {LADDER_BITS} bits"}

    def times(d):
        return {k: d.get(k) for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                      "device_ms_per_launch", "event_ms_per_launch")}

    kernels = [
        {
            "name": "fp_mul_lazy", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/fp_mul_lazy.cu",
            "replaces": "hbbft_tpu/ops/pallas_fp.py:116",
            "launches": launches["fp_mul_lazy"],
            "max_abs_err": ctx["fp"]["max_abs_err"],
            "ms": fp_main["ms"], "plain_ms": fp_main["plain_ms"],
            "bound_ms": fp_main["bound_ms"], "bound_by": fp_main["bound_by"],
            "library_ms": None,
            "device_ms_per_launch": fp_main.get("device_ms_per_launch"),
            "n1024": {"launches": launches_l["fp_mul_lazy"],
                      "shape": "none: it runs inside the ladder kernel"},
            "n4096": {"launches": launches_x["fp_mul_lazy"],
                      "shape": "none: it runs inside the ladder kernel"},
            "objsim22": {"launches": ctx["objsim_launches"]["fp_mul_lazy"]},
            "vidsim22": {"launches": ctx["vidsim_launches"]["fp_mul_lazy"]},
            "netsim22": {"launches": ctx["netsim_launches"]["fp_mul_lazy"]},
            "edge22": {"launches": ctx["edge22_launches"].get("fp_mul_lazy", 0)},
            "campaign": {"launches": ctx["campaign_launches"]["fp_mul_lazy"]},
            "n16384": {"launches": launches_h["fp_mul_lazy"]},
        },
        {
            "name": "sha3_256", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/keccak.cu",
            "replaces": "hbbft_tpu/ops/keccak.py:284",
            "launches": launches["sha3_256"],
            "max_abs_err": ctx["sha3"]["max_abs_err"],
            "ms": sha["ms"], "plain_ms": sha["plain_ms"],
            "bound_ms": sha["bound_ms"], "bound_by": sha["bound_by"],
            "library_ms": None,
            "device_ms_per_launch": {k: v["device_ms_per_launch"]
                                     for k, v in ctx["sha3"]["shapes"].items()},
            "shape": f"{ctx['sha3']['main']} (the Merkle leaf level)",
            "n1024": {"launches": launches_l["sha3_256"], **times(sha_l),
                      "shape": f"{ctx['sha3']['main_n1024']} (one chunk's Merkle leaf level)"},
            "n4096": {"launches": launches_x["sha3_256"], **times(sha_x),
                      "shape": f"{ctx['sha3']['main_n4096']} (one chunk's Merkle leaf level)"},
            "sustained4096": {"launches": launches_s["sha3_256"], "epochs": SUSTAINED_EPOCHS,
                              "run": "pipelined"},
            "qhb64": {"launches": ctx["qhb64_launches"]["sha3_256"],
                      "epochs": QHB_EPOCHS, "run": "pipelined"},
            "mesh64": {"launches": ctx["mesh64_launches"]["sha3_256"],
                       "run": "the N = 64 epoch sharded over a 1-rank NCCL mesh"},
            "objsim22": {"launches": ctx["objsim_launches"]["sha3_256"],
                         "run": "object mode hashes its Merkle trees on the host"},
            "vidsim22": {"launches": ctx["vidsim_launches"]["sha3_256"],
                         "run": "object mode hashes its Merkle trees on the host"},
            "netsim22": {"launches": ctx["netsim_launches"]["sha3_256"],
                         "run": "the node runtime hashes its Merkle trees on the host"},
            "edge22": {"launches": ctx["edge22_launches"].get("sha3_256", 0),
                       "run": "the node processes hash their Merkle trees on the host"},
            "campaign": {"launches": ctx["campaign_launches"]["sha3_256"],
                         "run": "the campaign's cells hash their Merkle trees on the host"},
            "n16384": {"launches": launches_h["sha3_256"]},
        },
        {
            "name": "ladder_lazy", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/ladder_lazy.cu",
            "replaces": "hbbft_tpu/ops/gcurve.py:245",
            "launches": launches["ladder_lazy"],
            "max_abs_err": lad["max_abs_err"],
            "ms": lad["ms"], "plain_ms": lad["plain_ms"],
            "bound_ms": lad["bound_ms"], "bound_by": lad["bound_by"],
            "library_ms": None,
            "ms_by_group": lad["ms_by_group"],
            "device_ms_per_launch": lad["device_ms_per_launch"],
            "event_ms_per_launch": lad["event_ms_per_launch"],
            "shape": "the N = 64 epoch's encrypt shapes summed (no path runs this kernel): "
                     "G1 {g1} rows + G2 {g2} rows, {bits} bits".format(bits=LADDER_BITS,
                                                                       **lad["rows"]),
            "n1024": {"launches": launches_l["ladder_lazy"]},
            "n4096": {"launches": launches_x["ladder_lazy"]},
            "objsim22": {"launches": ctx["objsim_launches"]["ladder_lazy"]},
            "vidsim22": {"launches": ctx["vidsim_launches"]["ladder_lazy"]},
            "netsim22": {"launches": ctx["netsim_launches"]["ladder_lazy"]},
            "edge22": {"launches": ctx["edge22_launches"].get("ladder_lazy", 0)},
            "campaign": {"launches": ctx["campaign_launches"]["ladder_lazy"]},
            "n16384": {"launches": launches_h["ladder_lazy"]},
        },
        {
            "name": "ladder_window", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/ladder_window.cu",
            "replaces": "hbbft_tpu/ops/gcurve.py:288",
            "launches": launches["ladder_window"],
            "max_abs_err": win["max_abs_err"],
            "library_ms": None,
            **epoch_w,
            "coin256": {"launches": ctx["coin256_launches"]["ladder_window"],
                        **window_sum([("g1", COIN_N), ("g2", COIN_N)])},
            "dkg256": {"launches": ctx["dkg256_launches"]["ladder_window"],
                       **window_sum([("g1", 2 * 8192)])},
            "n1024": {"launches": launches_l["ladder_window"],
                      **window_sum([("g1", 4 * N_LARGE), ("g2", 2 * N_LARGE)])},
            # N = 4096 encrypts in chunks of 1 024 proposers: n1024's shapes
            "n4096": {"launches": launches_x["ladder_window"],
                      "chunks_per_epoch": launches_x["ladder_window"] // 2,
                      **window_sum([("g1", 4 * N_LARGE), ("g2", 2 * N_LARGE)])},
            "g2_8192": window_sum([("g2", 2 * N_4096)]),
            "sustained4096": {"launches": launches_s["ladder_window"],
                              "epochs": SUSTAINED_EPOCHS, "run": "pipelined"},
            "qhb64": {"launches": ctx["qhb64_launches"]["ladder_window"],
                      "epochs": QHB_EPOCHS, "run": "pipelined"},
            "mesh64": {"launches": ctx["mesh64_launches"]["ladder_window"],
                       "run": "the N = 64 epoch sharded over a 1-rank NCCL mesh"},
            "objsim22": {"launches": ctx["objsim_launches"]["ladder_window"],
                         "device_folds": ctx["objsim_folds"],
                         **window_sum([("g1", 16)]),
                         "run": "object mode at N = 22: one launch a share-set fold"},
            "vidsim22": {"launches": ctx["vidsim_launches"]["ladder_window"],
                         "device_folds": ctx["vidsim_folds"],
                         "run": "the VID and the classic node stack at N = 22, one epoch "
                                "each: one launch a share-set fold"},
            "netsim22": {"launches": ctx["netsim_launches"]["ladder_window"],
                         "device_folds": ctx["netsim_folds"],
                         "run": "the classic and the VID node runtime over localhost TCP at "
                                "N = 22: two launches a merged share-set job"},
            "edge22": {"launches": ctx["edge22_launches"].get("ladder_window", 0),
                       "device_folds": ctx["edge22_folds"],
                       "run": "22 node processes behind a gateway, summed over the "
                              "processes: two launches a merged share-set job"},
            "campaign": {"launches": ctx["campaign_launches"]["ladder_window"],
                         "run": "smoke_grid, the equivocator under loss and two socket "
                                "cells, encryption off: no share-set fold"},
            "n16384": {"launches": launches_h["ladder_window"]},
        },
        {
            "name": "ladder_mxu", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/ladder_mxu.cu",
            "replaces": "hbbft_tpu/ops/gcurve.py:288 (over hbbft_tpu/ops/fp381_mxu.py:178)",
            "launches": ctx["mxu_launches"]["epoch"],
            "max_abs_err": mxu["max_abs_err"],
            "library_ms": None,
            **mxu_sum([("g1", 4 * N_NODES), ("g2", 2 * N_NODES)]),
            "run": "the N = 64 epoch under HBBFT_FIELD_BACKEND=mxu",
            "default_route": {"launches": launches["ladder_mxu"],
                              "run": "the N = 64 epoch: MXU_MAX_BATCH is None"},
            "coin256": {"launches": ctx["mxu_launches"]["coin256"],
                        **mxu_sum([("g2", COIN_N)]),
                        "run": "coin256's verify under HBBFT_FIELD_BACKEND=mxu"},
            "fold16": mxu_sum([("g1", 16)]),
            "n1024": {"launches": launches_l["ladder_mxu"]},
            "n4096": {"launches": launches_x["ladder_mxu"]},
            "objsim22": {"launches": ctx["objsim_launches"]["ladder_mxu"]},
            "vidsim22": {"launches": ctx["vidsim_launches"]["ladder_mxu"]},
            "netsim22": {"launches": ctx["netsim_launches"]["ladder_mxu"]},
            "edge22": {"launches": ctx["edge22_launches"].get("ladder_mxu", 0)},
            "campaign": {"launches": ctx["campaign_launches"]["ladder_mxu"]},
            "n16384": {"launches": launches_h["ladder_mxu"]},
        },
        {
            "name": "bitplane", "route": "cuda",
            "source": "hbbft_tpu_torch/csrc/bitplane.cu",
            "replaces": "hbbft_tpu/ops/gf256.py:301",
            "launches": launches["bitplane"],
            "max_abs_err": bp["max_abs_err"],
            **plane(bp["cases"]["n64_encode"]),
            "shape": "the N = 64 epoch's GF(2^8) encode: 64 proposers x 2 924 byte rows, "
                     "176 bits, 336 columns",
            "masked_decode": plane(bp["cases"]["masked_decode"]),
            "n1024": {"launches": launches_l["bitplane"], **plane(bp["cases"]["n1024_chunk"])},
            "n4096": {"launches": launches_x["bitplane"], **plane(bp["cases"]["n4096_chunk"])},
            "n16384": {"launches": launches_h["bitplane"], **plane(ctx["bitplane_n16384"])},
            "sustained4096": {"launches": launches_s["bitplane"], "epochs": SUSTAINED_EPOCHS,
                              "run": "pipelined"},
            "qhb64": {"launches": ctx["qhb64_launches"]["bitplane"],
                      "epochs": QHB_EPOCHS, "run": "pipelined"},
            "mesh64": {"launches": ctx["mesh64_launches"]["bitplane"],
                       "run": "the N = 64 epoch sharded over a 1-rank NCCL mesh"},
            "dhb": {"launches": ctx["dhb_launches"]["bitplane"],
                    "run": "the era change's epochs"},
            "objsim22": {"launches": ctx["objsim_launches"]["bitplane"],
                         "run": "object mode at N = 22, the native erasure backend"},
            "objsim10_device": {"launches": ctx["objsim10_device_launches"]["bitplane"],
                                "run": "object mode at N = 10, the device erasure backend: "
                                       "one launch a product"},
            "vidsim22": {"launches": ctx["vidsim_launches"]["bitplane"],
                         "run": "one launch a product of the device erasure backend"},
            "netsim22": {"launches": ctx["netsim_launches"]["bitplane"],
                         "run": "one launch a product of the device erasure backend"},
            "edge22": {"launches": ctx["edge22_launches"].get("bitplane", 0),
                       "run": "22 node processes, summed: one launch a device erasure product"},
            "campaign": {"launches": ctx["campaign_launches"]["bitplane"],
                         "run": "this process's cells: one launch a device erasure product"},
        },
    ]
    return {"kernels": kernels}


def _parse_args(argv, names):
    """``--phases a,b``: run only those phases (``build`` first), with no
    ``kernels`` line; no ``--phases``: every phase.  ``--dhb-n N``: the
    ``dhb`` phase at N validators (default DHB_N).  ``--keep-journals
    DIR``: ``edge22`` keeps the first segment of each node's journal in
    DIR.  Returns (phases or None, dhb N, journal directory or "")."""
    usage = ("usage: chip_smoke.py [--phases name,name,...] [--dhb-n N] "
             "[--keep-journals DIR]")
    opts = dict(zip(argv[::2], argv[1::2]))
    if len(argv) % 2 or set(opts) - {"--phases", "--dhb-n", "--keep-journals"}:
        raise SystemExit(usage)
    only = None
    if "--phases" in opts:
        only = set(opts["--phases"].split(","))
        if only - set(names):
            raise SystemExit(f"unknown phases {sorted(only - set(names))}; phases: {names}")
        only |= {"build"}
    return only, int(opts.get("--dhb-n", DHB_N)), opts.get("--keep-journals", "")


def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import hbbft_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the hbbft_tpu_torch package is missing: {exc}",
              file=sys.stderr)
        return 2

    ctx = {"smi": smi("name,power.limit")}
    # the int32 ceilings: every SM at the maximum clock
    ctx["max_sm_clock_mhz"] = float(smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctx["sm_clocks_per_s"] = sms * ctx["max_sm_clock_mhz"] * 1e6
    emit({"peak": {"max_sm_clock_mhz": ctx["max_sm_clock_mhz"], "sms": sms,
                   "alu_or_fma_pipe_per_clock_per_sm": PIPE_PER_CLOCK_PER_SM,
                   "dispatch_per_clock_per_sm": DISPATCH_PER_CLOCK_PER_SM,
                   "pipe_ops_per_s": PIPE_PER_CLOCK_PER_SM * ctx["sm_clocks_per_s"],
                   "bytes_per_s": PEAK_BYTES_PER_S}})
    # shard bytes of the epochs' ciphertexts
    ctx["leaf_bytes"] = shard_bytes(CIPHERTEXT_BYTES, N_NODES - 2 * 21)
    ctx["leaf_bytes_large"] = shard_bytes(CIPHERTEXT_BYTES, N_LARGE - 2 * F_LARGE)
    ctx["leaf_bytes_4096"] = shard_bytes(294 + CONTRIB_BYTES_4096, N_4096 - 2 * F_4096)
    phases = [("build", phase_build), ("lint", phase_lint),
              ("kernel_field", phase_kernel_field),
              ("kernel_fp_mul_lazy", phase_kernel_fp),
              ("kernel_sha3", phase_kernel_sha3), ("kernel_bitplane", phase_kernel_bitplane),
              ("kernel_ladder", phase_kernel_ladder),
              ("kernel_ladder_window", phase_kernel_ladder_window),
              ("ladder_crossover", phase_ladder_crossover),
              ("kernel_ladder_mxu", phase_kernel_ladder_mxu),
              ("epoch", phase_epoch), ("profile", phase_profile), ("qhb64", phase_qhb64),
              ("rbc_large", phase_rbc_large), ("epoch1024", phase_epoch1024),
              ("epoch4096", phase_epoch4096), ("sustained4096", phase_sustained4096),
              ("epoch16384", phase_epoch16384),
              ("mesh", phase_mesh), ("coin256", phase_coin256), ("dkg256", phase_dkg256), ("dhb", phase_dhb),
              ("objsim", phase_objsim), ("vidsim", phase_vidsim), ("netsim", phase_netsim),
              ("edge22", phase_edge22)]
    only, ctx["dhb_n"], ctx["keep_journals"] = _parse_args(sys.argv[1:], [n for n, _ in phases])
    ok = True
    for name, fn in phases:
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        try:
            res = fn(ctx)
            emit({"phase": name, "ok": True, "seconds": time.perf_counter() - t0, **res})
        except Exception as exc:  # report every phase, then fail
            traceback.print_exc()
            emit({"phase": name, "ok": False, "error": repr(exc)})
            ok = False
            if name == "build":
                break
    if not ok:
        return 1
    if not only:
        emit(phase_kernels(ctx))
    emit({"run_seconds": time.perf_counter() - t_start})
    print(ctx["smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--edge-node"]:
        sys.exit(_edge_node(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
