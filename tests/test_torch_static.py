"""Static guarantees of the PyTorch port: it imports neither JAX nor the
JAX package, and its entry points do not fall back to the CPU on their
own when no card is present."""

import ast
import json
import pathlib
import re

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "hbbft_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the mesh modules, named so that a move out of the package fails here
MESH_FILES = [ROOT / "hbbft_tpu_torch" / "parallel" / "mesh.py",
              ROOT / "hbbft_tpu_torch" / "graft_entry.py"]
# object mode: the protocol stack, the simulator and the CLI
OBJECT_MODE_FILES = [ROOT / "hbbft_tpu_torch" / rel for rel in (
    "traits.py", "fault_log.py", "simulation.py",
    "sim/__init__.py", "sim/trace.py", "sim/virtual_net.py", "sim/adversary.py",
    "protocols/broadcast.py", "protocols/binary_agreement.py",
    "protocols/subset.py", "protocols/threshold_sign.py",
    "protocols/threshold_decrypt.py", "protocols/honey_badger.py",
    "protocols/dynamic_honey_badger.py", "protocols/queueing_honey_badger.py",
    "protocols/wire.py")]
# the node stack without the network: sender queue, VID, retrieval, join
# snapshots, link shaping
NODE_STACK_FILES = [ROOT / "hbbft_tpu_torch" / rel for rel in (
    "protocols/sender_queue.py", "protocols/vid.py", "net/__init__.py",
    "net/retrieve.py", "snapshot.py", "chaos/__init__.py", "chaos/link.py")]
# the node runtime over real sockets: the obs core and net/ from framing to
# the cluster
NET_OBS_FILES = [ROOT / "hbbft_tpu_torch" / rel for rel in (
    "obs/__init__.py", "obs/metrics.py", "obs/trace.py", "obs/spans.py",
    "obs/flight.py", "obs/http.py", "obs/perf.py",
    "net/framing.py", "net/ingress.py", "net/transport.py", "net/scheduler.py",
    "net/client.py", "net/degrade.py", "net/statesync.py", "net/runtime.py",
    "net/cluster.py")]

# the operator's edge and toolkit: gateway, load generator, launcher, the
# socket adversaries, the post-mortem and live tools, the campaign
EDGE_FILES = [ROOT / "hbbft_tpu_torch" / rel for rel in (
    "sim/adversary.py", "net/gateway.py", "net/loadgen.py", "cluster_launch.py",
    "obs/audit_stream.py", "obs/audit.py", "obs/critpath.py", "obs/top.py",
    "obs/watch.py", "chaos/campaign.py")]


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


@pytest.mark.parametrize("path", MESH_FILES, ids=lambda p: p.name)
def test_mesh_modules_are_held_to_the_import_rule(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("path", OBJECT_MODE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "hbbft_tpu_torch")))
def test_object_mode_modules_are_held_to_the_import_rule(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("path", NODE_STACK_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "hbbft_tpu_torch")))
def test_node_stack_modules_are_held_to_the_import_rule(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("path", NET_OBS_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "hbbft_tpu_torch")))
def test_net_and_obs_modules_are_held_to_the_import_rule(path):
    assert path in PORT_FILES


@pytest.mark.parametrize("path", EDGE_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "hbbft_tpu_torch")))
def test_edge_and_toolkit_modules_are_held_to_the_import_rule(path):
    assert path in PORT_FILES


_SPAWNS_REFERENCE = re.compile(r"-m\s+hbbft_tpu\.")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_spawns_no_module_of_the_jax_package(path):
    """No command line the port builds names a ``hbbft_tpu.`` module: not as
    ``"-m", "hbbft_tpu...."`` list items, not inside one string."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.List):
            items = [e.value if isinstance(e, ast.Constant) else None for e in node.elts]
            for a, b in zip(items, items[1:]):
                assert not (a == "-m" and isinstance(b, str) and b.startswith("hbbft_tpu.")), \
                    f"{path.name}:{node.lineno} spawns {b}"
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not _SPAWNS_REFERENCE.search(node.value), f"{path.name}:{node.lineno}"


def test_edge_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    """The multi-process launcher, ``loadgen --spawn``, ``spawn_cluster`` and
    the campaign's runners and CLI default to ``cuda`` and raise without a
    card, before any node or cell starts."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from hbbft_tpu_torch import cluster_launch
    from hbbft_tpu_torch.chaos import campaign
    from hbbft_tpu_torch.net import cluster, loadgen

    args = cluster_launch.parse_args(["--flight-dir", "off"])
    assert args.device == "cuda" and cluster_launch.build_config(args).device == "cuda"
    sim = campaign.smoke_grid()[0]
    sock = campaign.CellSpec(kind="socket", adversary="garbage-stream", pipeline_depth=2)
    churn = campaign.CellSpec(kind="churn")
    root = str(tmp_path)
    for make in (
        lambda: cluster_launch.main(["--nodes", "4", "--flight-dir", "off"]),
        lambda: cluster.spawn_cluster(cluster.ClusterConfig(n=4, base_port=23000)),
        lambda: loadgen.main(["--spawn", "--n", "4"]),
        lambda: campaign.run_cell(sim, root),
        lambda: campaign.run_churn_cell(churn, root),
        lambda: campaign.run_socket_cell(sock, root),
        lambda: campaign.run_campaign([sim], root),
        lambda: campaign.main(["--grid", "smoke", "--journal-root", root]),
        lambda: campaign.main(["--replay", json.dumps(sim.as_dict()), "--journal-root", root]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    detail, _res = campaign.run_cell(sim, str(tmp_path / "cpu"), device="cpu")
    assert detail["verdict"] == "clean"


def test_cluster_entry_points_default_to_cuda_and_raise_without_it():
    """``ClusterConfig()`` names ``cuda``: the builders, ``LocalCluster``,
    ``spawn_node`` (before it starts a child) and the node CLI raise
    without a card; ``device="cpu"`` reaches every node's stack."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from hbbft_tpu_torch import snapshot
    from hbbft_tpu_torch.net import cluster

    cfg = cluster.ClusterConfig(n=4, encrypt=True)
    assert cfg.device == "cuda"
    infos = cluster.generate_infos(cfg)
    cpu = cluster.ClusterConfig(n=4, encrypt=True, device="cpu")
    snap = snapshot.capture_join_snapshot(cluster.build_algo(cpu, infos, 0).algo.dhb,
                                          b"\x00" * 32, 0)
    fixed = cluster.ClusterConfig(n=4, base_port=23000)
    for make in (
        lambda: cluster.LocalCluster(cfg),
        lambda: cluster.build_algo(cfg, infos, 0),
        lambda: cluster.build_runtime(cfg, infos, 0),
        lambda: cluster.build_runtime(cluster.ClusterConfig(n=4, vid=True), infos, 0),
        lambda: cluster.build_joiner_runtime(cfg, snap, 0),
        lambda: cluster.spawn_node(fixed, 0),
        lambda: cluster.main(["--nodes", "4", "--node-id", "0", "--base-port", "23000"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert cluster.build_algo(cpu, infos, 1).algo.dhb.hb.device == torch.device("cpu")
    assert "--device" in cluster.node_command(
        cluster.ClusterConfig(n=4, base_port=23000, device="cpu"), 0)


def test_node_stack_defaults_to_cuda_and_raises_without_it():
    """VID's dispersal and retrieval, and the join-snapshot builders, default
    to ``cuda`` and raise without a card; ``VidQueueingHoneyBadger`` hands
    its DHB's device to its ``Disperser``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import random

    from hbbft_tpu_torch import snapshot
    from hbbft_tpu_torch.net import RetrieveService, ShardStore
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.sender_queue import SenderQueue
    from hbbft_tpu_torch.protocols.vid import Disperser, VidQueueingHoneyBadger

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    sk = nets[0].secret_key()
    snap = snapshot.capture_join_snapshot(DynamicHoneyBadger(nets[0], sk, device="cpu"),
                                          b"\x00" * 32, 0)
    for make in (
        lambda: Disperser(ShardStore()),
        lambda: RetrieveService(0, ShardStore()),
        lambda: snapshot.build_joiner(snap, 0, sk, config_netinfo=nets[0]),
        lambda: VidQueueingHoneyBadger(DynamicHoneyBadger.builder(nets[0], sk).build()),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    stack = SenderQueue(VidQueueingHoneyBadger(
        DynamicHoneyBadger.builder(nets[0], sk).device("cpu").build()))
    assert stack.algo.disperser.device == torch.device("cpu")
    joiner = snapshot.build_joiner(snap, 0, sk, config_netinfo=nets[0], device="cpu")
    assert joiner.algo.dhb.hb.device == torch.device("cpu")


def test_object_mode_builders_default_to_cuda_and_raise_without_it(monkeypatch):
    """The object-mode builders, protocols with a device seam, the CLI (a
    ``NetBuilder`` user) and the ``device`` erasure backend default to
    ``cuda`` and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import random

    import numpy as np

    from hbbft_tpu_torch import simulation
    from hbbft_tpu_torch.crypto import tc
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.ops import rs
    from hbbft_tpu_torch.protocols.broadcast import Broadcast
    from hbbft_tpu_torch.protocols.dynamic_honey_badger import DynamicHoneyBadger
    from hbbft_tpu_torch.protocols.honey_badger import HoneyBadger, HoneyBadgerBuilder
    from hbbft_tpu_torch.protocols.queueing_honey_badger import QueueingHoneyBadger
    from hbbft_tpu_torch.protocols.subset import Subset
    from hbbft_tpu_torch.protocols.threshold_decrypt import ThresholdDecrypt
    from hbbft_tpu_torch.sim import NetBuilder

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    sk = nets[0].secret_key()
    plan = DynamicHoneyBadger(nets[0], sk, device="cpu").join_plan()
    for make in (
        lambda: HoneyBadgerBuilder(nets[0]).build(),
        lambda: HoneyBadger.builder(nets[0]).session_id(b"s").build(),
        lambda: HoneyBadger(nets[0]),
        lambda: DynamicHoneyBadger.builder(nets[0], sk).build(),
        lambda: DynamicHoneyBadger(nets[0], sk),
        lambda: DynamicHoneyBadger.from_join_plan(9, tc.SecretKey.random(random.Random(2)), plan),
        lambda: QueueingHoneyBadger.builder(DynamicHoneyBadger.builder(nets[0], sk).build()).build(),
        lambda: Subset(nets[0], b"s"),
        lambda: Broadcast(nets[0], 0),
        lambda: ThresholdDecrypt(nets[0]),
        lambda: NetBuilder([0, 1, 2, 3]).using_step(
            lambda nid: HoneyBadger.builder(nets[nid]).build()),
        lambda: simulation.main(["--nodes", "4"]),
        lambda: simulation.main(["--nodes", "4", "--batched"]),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the builders' device reaches what they build
    hb = HoneyBadger.builder(nets[0]).device("cpu").build()
    dhb = DynamicHoneyBadger.builder(nets[0], sk).device("cpu").build()
    qhb = QueueingHoneyBadger.builder(dhb).build()
    assert hb.device == dhb.device == qhb.dhb.hb.device == torch.device("cpu")
    # the erasure backend ``device`` runs on the caller's device, cuda unless told
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "device")
    coder = rs.for_n_f(4, 1)
    data = np.zeros((2, 8), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        coder.encode_np(data)
    assert coder.encode_np(data, device="cpu").shape == (4, 8)


def test_bitplane_callers_raise_on_a_cuda_request_without_a_card(monkeypatch):
    """The bit-plane kernel's operands for a CUDA device (both coders'
    packed parity matrices and encode matrices) and the ``device`` erasure
    backend's GF(2^16) decode, which launches it on ``cuda`` unless told,
    raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import numpy as np

    from hbbft_tpu_torch.ops import rs

    for coder in (rs.for_n_f(64, 21), rs.for_n_f(259, 86)):
        for make in (lambda: coder._on("cuda"), lambda: coder.matrix_on("cuda")):
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
    monkeypatch.setenv("HBBFT_ERASURE_BACKEND", "device")
    coder = rs.for_n_f(259, 86)
    survivors = np.zeros((coder.data_shards, 4), dtype=np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        coder.reconstruct_data_np(survivors, tuple(range(coder.data_shards)))


def test_entry_points_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    import random

    import types

    from hbbft_tpu_torch import graft_entry
    from hbbft_tpu_torch.crypto import batch
    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel import mesh
    from hbbft_tpu_torch.parallel.acs import BatchedAcs, BatchedHoneyBadgerEpoch

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    cuda_mesh = types.SimpleNamespace(device_type="cuda")  # a CUDA DeviceMesh's view
    for make in (
        lambda: graft_entry.entry(),
        lambda: graft_entry.dryrun_multichip(1),
        lambda: graft_entry.start_world(1, print),
        lambda: mesh.make_sharded_coin_verify(None),
        lambda: mesh.make_sharded_decrypt(None),
        lambda: mesh.mesh_device(cuda_mesh),
        lambda: BatchedHoneyBadgerEpoch(nets, device="cpu", mesh=cuda_mesh),
        lambda: BatchedAcs(4, 1, device="cpu", mesh=cuda_mesh),
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
    """Importing the port's protocol stack, the drivers, the simulator and
    the CLI (and registering every wire message) in a fresh interpreter
    adds no module of ``jax`` or ``hbbft_tpu`` to ``sys.modules``."""
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
        "import hbbft_tpu_torch.simulation, hbbft_tpu_torch.sim, hbbft_tpu_torch.traits\n"
        "import hbbft_tpu_torch.protocols.wire as w; w.ensure_registered()\n"
        "import hbbft_tpu_torch.protocols.vid, hbbft_tpu_torch.protocols.sender_queue\n"
        "import hbbft_tpu_torch.net, hbbft_tpu_torch.snapshot, hbbft_tpu_torch.chaos\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'hbbft_tpu'))\n"
        "assert 'hbbft_tpu_torch.protocols.sync_key_gen' in new\n"
        "assert 'hbbft_tpu_torch.protocols.broadcast' in new\n"
        "assert 'hbbft_tpu_torch.net.retrieve' in new and 'hbbft_tpu_torch.chaos.link' in new\n"
        "print(bad)\n"
    )
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env=env)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_dryrun_multichip_raises_with_fewer_cards_than_asked():
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA cards are present: the dry run can run")
    from hbbft_tpu_torch.graft_entry import dryrun_multichip

    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(2)


def test_mesh_attached_runners_refuse_to_pickle(tmp_path):
    """A mesh binds this world's process groups: the epoch, the ACS runner
    and the drivers refuse to pickle with one, as the reference's do, and
    pickle without one."""
    import pickle
    import random

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from hbbft_tpu_torch.netinfo import NetworkInfo
    from hbbft_tpu_torch.parallel import (
        BatchedAcs,
        BatchedDynamicHoneyBadger,
        BatchedHoneyBadgerEpoch,
        BatchedQueueingDynamicHoneyBadger,
        BatchedQueueingHoneyBadger,
    )

    nets = NetworkInfo.generate_map([0, 1, 2, 3], random.Random(1))
    makers = (
        lambda m: BatchedHoneyBadgerEpoch(nets, device="cpu", mesh=m),
        lambda m: BatchedAcs(4, 1, device="cpu", mesh=m),
        lambda m: BatchedQueueingHoneyBadger(nets, device="cpu", mesh=m),
        lambda m: BatchedDynamicHoneyBadger(nets, device="cpu", mesh=m),
        lambda m: BatchedQueueingDynamicHoneyBadger(nets, device="cpu", mesh=m),
    )
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("nodes",))
        for make in makers:
            with pytest.raises(TypeError, match="mesh"):
                pickle.dumps(make(mesh))
            pickle.dumps(make(None))
    finally:
        dist.destroy_process_group()
