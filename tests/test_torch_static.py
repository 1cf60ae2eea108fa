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


def test_drivers_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import random

    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel import (
        BatchedDynamicHoneyBadger,
        BatchedQueueingDynamicHoneyBadger,
        BatchedQueueingHoneyBadger,
    )
    from hbbft_tpu_torch.protocols.sync_key_gen import SyncKeyGen

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    sk = tc.SecretKey.random(random.Random(2))
    for make in (
        lambda: BatchedQueueingHoneyBadger(nets),
        lambda: BatchedQueueingDynamicHoneyBadger(nets),
        lambda: BatchedDynamicHoneyBadger(nets),
        lambda: SyncKeyGen(0, sk, {0: sk.public_key()}, 0, random.Random(3)),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()


def test_protocols_package_loads_neither_jax_nor_the_jax_package():
    """Importing the port's host protocol types (and the drivers over them)
    in a fresh interpreter adds no module of ``jax`` or ``hbbft_tpu`` to
    ``sys.modules``."""
    import os
    import subprocess
    import sys

    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import hbbft_tpu_torch.protocols\n"
        "import hbbft_tpu_torch.protocols.dynamic_honey_badger\n"
        "import hbbft_tpu_torch.protocols.queueing_honey_badger\n"
        "import hbbft_tpu_torch.parallel.dhb, hbbft_tpu_torch.parallel.qhb\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'hbbft_tpu'))\n"
        "assert 'hbbft_tpu_torch.protocols.sync_key_gen' in new\n"
        "print(bad)\n"
    )
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=env)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
