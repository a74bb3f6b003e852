"""The benchmark's files: every cell, configuration, traffic, job and reader
loads, names and units keep to their characters, and each per-layer
metric's cells report the end-to-end metric it moves."""

import json
import re

import pytest

import tiny  # noqa: F401  (puts portbench on the path)
import pb_check
import pb_harness as H

BENCH = json.loads((H.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads(w):
    cell = H.load_cell(w["name"])
    assert cell.chips == 1
    # every number the check makes is limited or named as not compared
    assert set(cell.limits) | set(cell.not_compared) == set(pb_check.NUMBERS)
    assert not set(cell.limits) & set(cell.not_compared)
    assert {"grad_gap", "change_gap"} <= set(cell.limits)
    assert any(k.startswith("replay_") for k in cell.limits)
    assert (H.HERE / "jobs" / f"{cell.traffic['job']}.py").exists()
    job = H.load_job(cell.traffic["job"])
    assert hasattr(job, "Job")
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(c):
    assert c["file"].startswith("portbench/")
    cfg = json.loads((H.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"]
    assert cfg["reduced"] == c["reduced"]
    # a key changed from the source says what it was
    assert set(cfg.get("reduced_from", {})) == set(c["reduced"])
    assert c["source"].startswith("https://")


def test_names_and_units():
    names = ([m["name"] for m in METRICS]
             + [w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for group in (METRICS, BENCH["workloads"], BENCH["configs"]):
        assert len({x["name"] for x in group}) == len(group)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_every_metric_has_a_reader():
    for folder, group in (("end_to_end", "end_to_end"), ("metrics", "per_layer")):
        for m in BENCH[group]:
            assert hasattr(H.load_module(H.reader(folder, m["name"])), "read")
        # and every reader file reads some metric
        stems = {H.reader(folder, m["name"]).name for m in BENCH[group]}
        assert stems == {p.name for p in (H.HERE / folder).glob("*.py")}


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moves = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moves["workloads"]), m["name"]
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    # a quantity split by the metric it moves keeps one layer name
    assert all(len(v) == 1 for v in layers.values())


def test_bounds_and_budget():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    s = BENCH["run_seconds"]
    assert 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
