"""The coders' device caches (``ops/rs.py``) key by one normalised device:
a CUDA device without an index is the current one, so a caller that passes
``"cuda"`` and one that passes ``cuda:0`` share one packed matrix.  Pinned on
the CPU with the CUDA availability and current-device calls stubbed and the
cache entry put in place by hand (nothing is built on a card)."""

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.ops import rs


@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda`` reporting a card whose current index the test sets."""
    state = {"current": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: state["current"])
    return state


@pytest.mark.parametrize("current", [0, 1])
def test_device_key_names_the_current_card(fake_cuda, current):
    fake_cuda["current"] = current
    want = torch.device("cuda", current)
    for spelling in ("cuda", torch.device("cuda"), f"cuda:{current}", want):
        assert rs.device_key(spelling) == want
    other = torch.device("cuda", 1 - current)
    assert rs.device_key(f"cuda:{1 - current}") == other != want
    assert rs.device_key("cpu") == torch.device("cpu")


@pytest.mark.parametrize("coder", [rs.ReedSolomon(4, 3), rs.ReedSolomon16(5, 4)],
                         ids=["gf256", "gf65536"])
@pytest.mark.parametrize("attr, cache", [("_on", "_dev"), ("matrix_on", "_mat_dev")])
def test_cuda_spellings_share_one_cached_matrix(fake_cuda, coder, attr, cache):
    sentinel = object()
    getattr(coder, cache)[torch.device("cuda", 0)] = sentinel
    try:
        for spelling in ("cuda", torch.device("cuda"), "cuda:0", torch.device("cuda", 0)):
            assert getattr(coder, attr)(spelling) is sentinel
        assert len(getattr(coder, cache)) == 1
    finally:
        getattr(coder, cache).clear()


def test_host_api_bits_cache_shares_the_key(fake_cuda):
    coder = rs.ReedSolomon(4, 3)
    matrix = coder.parity_matrix
    sentinel = object()
    coder._bits_cache.put(("k", torch.device("cuda", 0)), sentinel)
    for spelling in ("cuda", "cuda:0", torch.device("cuda")):
        assert rs._bits_on(coder._bits_cache, "k", matrix, None, spelling) is sentinel


def test_cpu_caches_still_build_once():
    coder = rs.ReedSolomon16(5, 4)
    a = coder._on("cpu")
    assert coder._on(torch.device("cpu")) is a
    assert coder.matrix_on("cpu") is coder.matrix_on(torch.device("cpu"))
    data = torch.from_numpy(np.arange(5 * 6, dtype=np.uint8).reshape(5, 6))
    out = coder.encode(data)
    assert np.array_equal(out.numpy(), coder.encode_np(data.numpy()))
    assert len(coder._dev) == 1
