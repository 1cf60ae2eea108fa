"""The simulation CLI: ``python -m hbbft_tpu_torch.simulation`` against the
JAX package's ``examples/simulation.py``.

- object mode (QHB over DHB on ``VirtualNet``) at ``--nodes 4``: the
  printed table — epochs, transactions, virtual times, message counts by
  type, wire bytes — is the reference's, the wall time aside;
- ``--batched``: the array-mode driver commits the reference's ledger
  (every transaction, in commit order) in the same epochs;
- ``--batched --remove-node``: every transaction commits across the era
  rotation (the port alone);
- argument errors are the reference's.

The port runs with ``--device cpu``.  Tolerance: exact.
"""

import pathlib
import re
import runpy

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
# wall seconds (object mode prints them once; the batched table in its
# last column, and a rate over them)
WALL = re.compile(r"wall \d+\.\d+s")
BATCHED_WALL = re.compile(r"wall \d+\.\d+s|\s+\d+\.\d+$|\(\d+ tx/s incl\. compile\)", re.M)


def _reference(monkeypatch, argv):
    mod = runpy.run_path(str(ROOT / "examples" / "simulation.py"), run_name="reference")
    monkeypatch.setattr("sys.argv", ["simulation.py", *argv])
    mod["main"]()


def _port(argv):
    from hbbft_tpu_torch import simulation

    return simulation.main([*argv, "--device", "cpu"])


def _outputs(monkeypatch, capsys, argv):
    _reference(monkeypatch, argv)
    ref = capsys.readouterr().out
    assert _port(argv) == 0
    return ref, capsys.readouterr().out


def test_object_mode_table_matches_reference(monkeypatch, capsys):
    argv = ["--nodes", "4", "--txs", "120", "--batch-size", "20", "--tx-size", "32"]
    ref, got = _outputs(monkeypatch, capsys, argv)
    assert "committed 120/120 txs" in got
    assert WALL.sub("wall", got) == WALL.sub("wall", ref)
    assert got.splitlines()[-1] == ref.splitlines()[-1]  # messages and bytes


def test_batched_mode_commits_reference_ledger(monkeypatch, capsys):
    import hbbft_tpu.parallel.qhb as jqhb
    import hbbft_tpu_torch.parallel.qhb as tqhb

    made = {}
    for name, mod in (("ref", jqhb), ("port", tqhb)):
        base = mod.BatchedQueueingHoneyBadger

        class Recorded(base):
            def __init__(self, *a, _name=name, **kw):
                super().__init__(*a, **kw)
                made[_name] = self

        monkeypatch.setattr(mod, "BatchedQueueingHoneyBadger", Recorded)
    argv = ["--nodes", "4", "--txs", "48", "--batch-size", "6", "--tx-size", "16",
            "--batched"]
    ref, got = _outputs(monkeypatch, capsys, argv)
    assert made["port"].committed == made["ref"].committed
    assert len(made["port"].committed) == 48
    assert made["port"].epoch == made["ref"].epoch
    assert BATCHED_WALL.sub("", got) == BATCHED_WALL.sub("", ref)


@pytest.mark.parametrize("argv", [["--remove-node", "1"],
                                  ["--batched", "--remove-node", "4"],
                                  ["--nodes", "1", "--batched", "--remove-node", "0"]])
def test_argument_errors_match_reference(monkeypatch, capsys, argv):
    with pytest.raises(SystemExit) as ref_exit:
        _reference(monkeypatch, argv)
    ref = capsys.readouterr().err.splitlines()[-1]
    with pytest.raises(SystemExit) as got_exit:
        _port(argv)
    got = capsys.readouterr().err.splitlines()[-1]
    assert got_exit.value.code == ref_exit.value.code == 2
    assert got.split(": error: ")[1] == ref.split(": error: ")[1]


def test_batched_remove_node_drains_across_the_rotation(capsys):
    """``--batched --remove-node``: the queueing-over-dynamic driver votes
    node 3 out after the first epoch and commits every transaction across
    the era rotation (the port alone: the reference's batched dynamic
    epochs compile for each payload shape)."""
    argv = ["--nodes", "4", "--txs", "40", "--batch-size", "5", "--batched",
            "--remove-node", "3"]
    assert _port(argv) == 0
    out = capsys.readouterr().out
    assert "# epoch 1: all validators vote to remove 3" in out
    assert re.search(r"committed 40/40 txs across the era rotation in \d+ epochs; "
                     r"era 1, validators \[0, 1, 2\]", out)
