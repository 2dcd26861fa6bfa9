"""The cells on the card, as the benchmark runs them: one short run of
each from the command line, and the control at the cell's own size.
Marked ``cuda``: they skip without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run

SPEC = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in SPEC["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_run_prints_a_correct_result(card, workload):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu", res["checks"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_at_the_cells_size(card, workload):
    res = run.run_cell(workload, 2**31 + 6, 1.0, trace=False, control=True)
    assert res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["control_checks"].values())


def test_run_without_a_card_prints_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
