"""The result line carries the fixed result keys and the compared numbers
last; without a card a run prints no result and exits non-zero."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import run as bench_run
from portbench.harness import common
from portbench.tests.conftest import ROOT, WORKLOADS, small_cell


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("name", WORKLOADS)
def test_line_keys(name, trace, monkeypatch):
    if trace:
        # The CPU has no device trace: the readers get one of plain ops.
        from portbench.harness import trace as T

        monkeypatch.setattr(T.Profiled, "__enter__", lambda self: setattr(self, "t0", time.perf_counter()) or self)
        monkeypatch.setattr(T.Profiled, "__exit__", lambda self, *e: setattr(self, "window_s", time.perf_counter() - self.t0))
        monkeypatch.setattr(T.Profiled, "ops", lambda self: ([T.Op("kernel", 0.0, 10.0)], [T.Op("host", 0.0, 20.0)]))
    cell = small_cell(name)
    fields, lines = bench_run.run(name, 2 ** 31 + 101, 0.3, trace, device="cpu", cell=cell,
                                  t_start=time.perf_counter())
    line = json.loads(common.result_line(**fields))
    keys = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(line["metrics"]) <= want
    if not trace:
        assert set(line["metrics"]) == want
    for c in line["checks"].values():
        assert set(c) == {"value", "limit", "ok"}
    assert lines[-len(line["checks"]):] == common.check_lines(fields["checks"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "ipol_vga.batch8",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_idle_share_of_one_slice():
    from portbench.harness.trace import Op, Trace

    ops = [Op("a", 0.0, 400.0), Op("b", 300.0, 300.0), Op("Memcpy DtoH", 800.0, 100.0)]
    tr = Trace(ops, 0.002, 2, 2, {}, {})
    assert tr.busy_s == pytest.approx(0.0007)
    assert tr.idle_share == pytest.approx(0.65)
    with pytest.raises(ValueError):
        Trace(ops, 0.0005, 2, 2, {}, {}).idle_share
