"""The chaos campaign: the port's runner against the JAX package's.

Simulator cells at N = 4 run through each package's ``run_cell`` (the port
on ``device="cpu"``): two cells of ``smoke_grid()`` (``none``/``null`` and
``lossy-1pct``/``reorder``) and the equivocator under loss, as
``tests/test_chaos_campaign.py`` builds it.  Each gives the same verdict,
timeline digest, batch counts, shaping counters, online-detection block
and critical-path summary in both packages, and the same triage: the
faulty node and the first divergent epoch, with a replay spec whose JSON
is the reference's (the replay hint names the port's CLI).  A cell replays
byte-identically through ``replay_matches`` and the ``--replay`` CLI.  One port-only socket cell,
``garbage-stream``, runs a real 4-node ``LocalCluster`` on the CPU with a
raw-socket injector: the cluster keeps committing, audits clean, and the
audit attributes the overload to the claimed identity.  Tolerance: exact.
"""

import contextlib
import importlib
import io
import json

import pytest

from hbbft_tpu_torch.chaos.campaign import CellSpec, smoke_grid

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def m(pkg, path):
    return importlib.import_module(f"{pkg}.{path}")


def run_cell(pkg, spec_doc, cell_dir):
    C = m(pkg, "chaos.campaign")
    spec = C.CellSpec.from_dict(spec_doc)
    kw = {} if pkg == "hbbft_tpu" else {"device": "cpu"}
    detail, res = C.run_cell(spec, cell_dir, **kw)
    detail = {k: v for k, v in detail.items() if k != "journal"}
    triage = C._triage(spec, res) if res.verdict != "clean" else None
    return spec, detail, res, triage


def smoke_specs():
    return [s for s in smoke_grid()
            if (s.shape, s.adversary) in (("none", "null"), ("lossy-1pct", "reorder"))]


CELLS = {
    "none-null": lambda: smoke_specs()[0],
    "lossy-reorder": lambda: smoke_specs()[1],
    "lossy-equivocate": lambda: CellSpec(shape="lossy-1pct", adversary="equivocate",
                                         seed=0, crank_limit=60_000),
}


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sim_cell_matches_reference(tmp_path, cell):
    spec_doc = CELLS[cell]().as_dict()
    got = {pkg: run_cell(pkg, spec_doc, str(tmp_path / pkg)) for pkg in PKGS}
    (rspec, rdet, rres, rtri), (pspec, pdet, pres, ptri) = got[PKGS[0]], got[PKGS[1]]
    assert pspec.name == rspec.name and pspec.as_dict() == rspec.as_dict()
    assert json.dumps(pdet, sort_keys=True) == json.dumps(rdet, sort_keys=True)
    if rtri is not None:
        # the replay hint names each package's own CLI
        assert ptri["replay"].pop("how") == rtri["replay"].pop("how").replace(
            "hbbft_tpu.", "hbbft_tpu_torch.")
    assert ptri == rtri
    assert pdet["batches_min"] >= 1
    if cell == "lossy-equivocate":
        assert pdet["verdict"] == "fault" and pspec.faulty == (3,)
        assert ptri["faulty_nodes"] == ["3"]
        era, epoch = ptri["first_divergent_epoch"]
        assert era == 0 and epoch >= 0
        assert json.dumps(ptri["replay"]["spec"]) == json.dumps(rtri["replay"]["spec"])
        assert CellSpec.from_dict(ptri["replay"]["spec"]) == pspec
    else:
        assert pdet["verdict"] == "clean" and ptri is None


def test_campaign_report_matches_reference(tmp_path):
    """``run_campaign`` over the two clean smoke cells: the same report
    but for the journal paths."""
    reports = []
    for pkg in PKGS:
        C = m(pkg, "chaos.campaign")
        specs = [C.CellSpec.from_dict(s.as_dict()) for s in smoke_specs()]
        kw = {} if pkg == "hbbft_tpu" else {"device": "cpu"}
        rep = C.run_campaign(specs, str(tmp_path / pkg), **kw)
        for d in rep["cells_detail"]:
            d.pop("journal")
        reports.append(json.dumps(rep, sort_keys=True))
    assert reports[1] == reports[0]
    assert json.loads(reports[1])["verdicts"] == {"clean": 2}


def test_replay_is_byte_identical(tmp_path):
    from hbbft_tpu_torch.chaos import campaign as C

    spec = smoke_specs()[1]
    d1, _ = C.run_cell(spec, str(tmp_path / "a"), device="cpu")
    assert C.replay_matches(spec, d1["timeline_digest"], str(tmp_path / "b"), device="cpu")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = C.main(["--replay", json.dumps({"spec": spec.as_dict()}),
                     "--journal-root", str(tmp_path / "cli"), "--device", "cpu"])
    doc = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and doc["byte_identical"] is True
    assert doc["timeline_digest"] == d1["timeline_digest"]


def test_garbage_stream_socket_cell_on_the_cpu(tmp_path):
    from hbbft_tpu_torch.chaos import campaign as C

    spec = CellSpec(kind="socket", shape="none", adversary="garbage-stream",
                    n=4, seed=0, pipeline_depth=2)
    detail, res = C.run_socket_cell(spec, str(tmp_path), device="cpu")
    assert detail["verdict"] == "clean", res.as_dict()
    assert detail["batches_min"] >= 1 and not detail["stalled"]
    assert detail["guard"]["injector"]["frames_sent"] > 0
    assert detail["guard"]["decode_strikes"] > 0
    assert detail["overload_attributed_to"] == ["3"]
