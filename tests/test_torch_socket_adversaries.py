"""The two socket adversaries, ``GarbageStreamAdversary`` and
``IdentitySpoofAdversary``: the port writes the reference's bytes.

Each package's adversary, with the same seed, dials a scripted localhost
victim (a plain asyncio server written here, not a node) that records every
byte a connection writes.  The victim answers the hello with a fixed
``CHALLENGE``; for the garbage stream (with the claimed validator's key) it
then accepts the ``AUTH`` with a ``HELLO`` and reads the flood, for the
spoofs it closes after the ``AUTH`` (or the hijack frame) — a refusal.
Per connection, the port's bytes equal the reference's: the hello, the
signed or random auth, the seeded garbage frames and the valid-frame
flood.  The ``_frame`` and ``_auth_payload`` sequences match as well.
Keys come from seed 3 (N = 4).  Tolerance: exact.
"""

import asyncio
import importlib
import random

import pytest

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")
CLUSTER_ID = b"adv-cluster"
NONCE, SESSION = bytes(range(32)), bytes(range(100, 108))
GARBAGE_FRAMES = 40


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def secret_key(pkg, nid=3):
    infos = m(pkg, "netinfo").NetworkInfo.generate_map(list(range(4)), random.Random(3))
    return infos[nid].secret_key()


async def victim(pkg, admit: bool, reads_after_auth: int):
    """A one-port scripted victim; returns (server, per-connection bytes)."""
    framing = m(pkg, "net.framing")
    conns = []

    async def handle(reader, writer):
        got = bytearray()
        conns.append(got)
        try:
            kind, payload = await framing.read_one_frame(reader)
            got += framing.encode_frame(kind, payload, framing.DEFAULT_MAX_FRAME)
            writer.write(framing.encode_frame(framing.CHALLENGE,
                                              framing.encode_challenge(NONCE, SESSION),
                                              framing.DEFAULT_MAX_FRAME))
            await writer.drain()
            kind, payload = await framing.read_one_frame(reader)
            got += framing.encode_frame(kind, payload, framing.DEFAULT_MAX_FRAME)
            if admit:
                hello = framing.Hello(node_id=0, role=framing.ROLE_NODE,
                                      cluster_id=CLUSTER_ID, era=0, epoch=0)
                writer.write(framing.encode_frame(framing.HELLO, framing.encode_hello(hello),
                                                  framing.DEFAULT_MAX_FRAME))
                await writer.drain()
                for _ in range(reads_after_auth):
                    kind, payload = await framing.read_one_frame(reader)
                    got += framing.encode_frame(kind, payload, framing.DEFAULT_MAX_FRAME)
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    return server, conns


async def garbage_run(pkg, valid_frames: bool):
    adv_mod = m(pkg, "sim.adversary")
    server, conns = await victim(pkg, admit=True, reads_after_auth=GARBAGE_FRAMES)
    adv = adv_mod.GarbageStreamAdversary(seed=5, budget_frames=GARBAGE_FRAMES,
                                         valid_frames=valid_frames,
                                         secret_key=secret_key(pkg))
    async with server:
        await adv.run(server.sockets[0].getsockname()[:2], CLUSTER_ID, identity=3,
                      duration_s=10.0)
        await asyncio.sleep(0.1)
    return [bytes(c) for c in conns], adv.frames_sent, adv.bytes_sent


def wrong_key(mode):
    return mode in ("wrongkey", "downgrade")


async def spoof_run(pkg, mode: str):
    adv_mod = m(pkg, "sim.adversary")
    server, conns = await victim(pkg, admit=False, reads_after_auth=0)
    wrong = (m(pkg, "crypto.tc").SecretKey.random(random.Random(7919 + 123))
             if wrong_key(mode) else None)
    adv = adv_mod.IdentitySpoofAdversary(seed=5, mode=mode, secret_key=wrong,
                                         claim_era=3 if mode == "downgrade" else 0,
                                         budget_attempts=3)
    async with server:
        await adv.run(server.sockets[0].getsockname()[:2], CLUSTER_ID, identity=3,
                      duration_s=10.0)
        await asyncio.sleep(0.1)
    return [bytes(c) for c in conns], adv.attempts, adv.refusals, adv.hellos_accepted


def both(coro_fn, *args):
    return {pkg: asyncio.run(asyncio.wait_for(coro_fn(pkg, *args), 30.0)) for pkg in PKGS}


@pytest.mark.parametrize("valid_frames", [False, True], ids=["garbage", "valid-flood"])
def test_garbage_stream_writes_the_reference_bytes(valid_frames):
    got = both(garbage_run, valid_frames)
    assert got[PKGS[1]] == got[PKGS[0]]
    conns, frames, sent = got[PKGS[1]]
    assert frames == GARBAGE_FRAMES and len(conns) == 1 and len(conns[0]) > sent


@pytest.mark.parametrize("mode", ["nokey", "wrongkey", "hijack", "downgrade"])
def test_identity_spoof_writes_the_reference_bytes(mode):
    got = both(spoof_run, mode)
    assert got[PKGS[1]] == got[PKGS[0]]
    conns, attempts, refusals, accepted = got[PKGS[1]]
    assert attempts == 3 and refusals == 3 and accepted == 0
    # a signed auth repeats (same key, same challenge); a random one does not
    assert len(conns) == 3 and len(set(conns)) == (1 if wrong_key(mode) else 3)


def test_frame_and_auth_sequences_match_reference():
    got = {}
    for pkg in PKGS:
        adv_mod = m(pkg, "sim.adversary")
        g = adv_mod.GarbageStreamAdversary(seed=11, frame_bytes=64)
        s = adv_mod.IdentitySpoofAdversary(seed=11, mode="nokey")
        got[pkg] = ([g._frame() for _ in range(8)],
                    [s._auth_payload(CLUSTER_ID, NONCE, SESSION, 2) for _ in range(4)])
    assert got[PKGS[1]] == got[PKGS[0]]
