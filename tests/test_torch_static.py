"""Static guarantees of the PyTorch port: it imports neither JAX nor the
JAX package, and its entry points do not fall back to the CPU on their
own when no card is present."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hbbft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = {"jax", "jaxlib", "hbbft_tpu"} & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import random

    from hbbft_tpu_torch.crypto import batch
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel.acs import BatchedAcs, BatchedHoneyBadgerEpoch

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    for make in (
        lambda: BatchedHoneyBadgerEpoch(nets),
        lambda: BatchedAcs(4, 1),
        lambda: BatchedAcs(1024, 341),
        lambda: batch.batch_tpke_encrypt_device(None, [b"x"], [1]),
        lambda: batch.cache_for("cuda"),
        lambda: batch.batch_verify_sig_shares([(None, None)], b"m", random.Random(1)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
