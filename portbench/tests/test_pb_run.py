"""The command itself: it refuses a host without a card, printing no
result; on the card (``cuda`` marker) a short run of the smallest cell
prints the contract's last line."""

import json
import subprocess
import sys

import pytest

import tiny  # noqa: F401  (puts portbench on the path)
import pb_harness as H

RUN = [sys.executable, str(H.HERE / "run.py")]


def test_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(RUN + ["--workload", "base-ft-as20k-b4", "--seed",
                                str(2 ** 33 + 1), "--seconds", "1",
                                "--trace", "0"],
                         capture_output=True, text=True, cwd=H.ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(RUN + ["--workload", "base-ft-as20k-b4", "--seed",
                                str(2 ** 33 + 2 + trace), "--seconds", "3",
                                "--trace", str(trace)],
                         capture_output=True, text=True, cwd=H.ROOT,
                         check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    cell = H.load_cell("base-ft-as20k-b4")
    wanted = cell.per_layer if trace else cell.end_to_end
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in wanted}
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert len(line["breakdown"]["device_ops"]) <= 10
