"""The streaming journal tail (``obs.audit_stream.JournalTailer``): the
port's rate against the JAX package's on the same journals.

A watchtower tails a cluster's journals with one ``JournalTailer.poll()`` a
tick; whether it keeps up with the nodes writing them is its rate in
records (and MB) a second.  :func:`measure` times one cold poll over every
journal under a root, then the ``AuditResult`` derivation a tick adds.
The test holds the two packages to the same count of records fed and the
same verdict on the N = 4 clean run of ``test_torch_audit_critpath.py``.
Run as a script on any journal root, it times each package in a process
of its own, in the order reference, port, port, reference, and prints one
JSON line a run::

    python tests/test_torch_tail_rate.py JOURNAL_ROOT
"""

import json
import os
import subprocess
import sys
import time

PKGS = ("hbbft_tpu", "hbbft_tpu_torch")


def measure(pkg: str, root: str) -> dict:
    """One cold ``JournalTailer.poll()`` of ``pkg`` over ``root``, then one
    ``result()``: records fed, bytes, seconds, rates, verdict."""
    import importlib

    stream = importlib.import_module(f"{pkg}.obs.audit_stream")
    tail = stream.JournalTailer([root], stream.IncrementalAuditor(max_events=0))
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _dirs, files in os.walk(root) for f in files)
    t0 = time.perf_counter()
    fed = tail.poll()
    poll_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = tail.result()
    result_s = time.perf_counter() - t0
    return {"pkg": pkg, "bytes": size, "records": fed, "poll_s": poll_s,
            "mb_per_s": size / 1e6 / poll_s, "records_per_s": fed / poll_s,
            "result_s": result_s, "verdict": res.verdict,
            "records_fed": tail.auditor.records_fed,
            "unmatched_receives": res.unmatched_receives}


def test_both_tails_feed_the_same_records(tmp_path):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_torch_audit_critpath import record_run

    root = record_run(str(tmp_path / "clean"))
    ref, port = (measure(pkg, root) for pkg in PKGS)
    assert port["records"] == ref["records"] > 0
    for key in ("bytes", "verdict", "records_fed", "unmatched_receives"):
        assert port[key] == ref[key], key
    assert port["verdict"] == "clean"


def main(argv) -> int:
    if argv[:1] == ["--pkg"]:
        print(json.dumps(measure(argv[1], argv[2])), flush=True)
        return 0
    if len(argv) != 1:
        raise SystemExit("usage: python tests/test_torch_tail_rate.py JOURNAL_ROOT")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [root, env.get("PYTHONPATH")]))
    for pkg in (PKGS[0], PKGS[1], PKGS[1], PKGS[0]):
        subprocess.run([sys.executable, __file__, "--pkg", pkg, argv[0]], env=env, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
