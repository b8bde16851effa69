"""``BENCHMARK.json`` against the contract's letter, and every name in it
against the files that the harness finds by that name."""

import os
import re

import pytest

from kingbench import run

M = run.load_json(run.REPO, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
E2E = {m["name"]: m for m in M["end_to_end"]}


def test_top_level_keys_and_sizes():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["paths"] == ["kingbench"] and M["command"][1] == "kingbench/run.py"
    assert 1 <= M["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(run.REPO, "BENCHMARK.json")) <= 64 << 10


KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.mark.parametrize("section", sorted(KEYS))
def test_each_entry_has_exactly_its_keys(section):
    required, optional = KEYS[section]
    for entry in M[section]:
        assert required <= set(entry) <= required | optional, (section, entry["name"])


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = ([x["why"] for x in M["workloads"] + M["configs"]]
             + [c["source"] for c in M["configs"]] + [m["layer"] for m in M["per_layer"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_end_to_end_bounds_and_sources():
    assert "setup_s" in E2E and E2E["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_reports_what_it_must(cell):
    config = next(c for c in M["configs"] if c["name"] == cell["config"])
    conf = run.load_json(run.REPO, config["file"])
    assert sorted(conf["reduced"]) == sorted(config["reduced"])
    traffic = run.load_json(run.HERE, "workloads", cell["traffic"] + ".json")
    assert os.path.exists(os.path.join(run.HERE, "modes", traffic["mode"] + ".py"))
    assert cell["chips"] in (1, 4)
    e2e = [m["name"] for m in run.metrics_of(M, "end_to_end", cell["name"])]
    layers = run.metrics_of(M, "per_layer", cell["name"])
    assert "setup_s" in e2e and len(e2e) >= 2 and layers
    for m in layers:
        assert m["moves"] in e2e, (m["name"], cell["name"])
        assert os.path.exists(os.path.join(run.HERE, "metrics", m["name"] + ".py"))


def four_card_cells_allowed(workloads: list[dict]) -> bool:
    """Every cell asks for 1 or 4 cards, and at most max(1, cells // 4) for
    4."""
    four = sum(1 for w in workloads if w["chips"] == 4)
    return (all(w["chips"] in (1, 4) for w in workloads)
            and four <= max(1, len(workloads) // 4))


def _cells(*chips):
    return [{"name": f"c{k}", "chips": n} for k, n in enumerate(chips)]


@pytest.mark.parametrize("workloads,allowed", [
    (M["workloads"], True),
    (_cells(1, 1, 1, 1, 4), True),
    (_cells(4), True),
    (_cells(1, 4), True),
    (_cells(1, 1, 1, 4, 4, 1, 1, 1), True),
    (_cells(1, 1, 1, 4, 4), False),
    (_cells(4, 4), False),
    (_cells(1, 1, 1, 1, 2), False),
    (_cells(8), False),
], ids=["BENCHMARK.json", "one_of_five", "one_of_one", "one_of_two", "two_of_eight",
        "two_of_five", "two_of_two", "two_cards", "eight_cards"])
def test_cells_take_one_or_four_cards_and_few_take_four(workloads, allowed):
    assert four_card_cells_allowed(workloads) is allowed


def test_each_metric_moves_one_end_to_end_metric_and_layers_are_named_alike():
    for m in M["per_layer"]:
        assert m["moves"] in E2E
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    layers = {m["layer"] for m in M["per_layer"]}
    perf = open(os.path.join(run.REPO, "PERF.md")).read()
    for layer in layers:
        assert f"**{layer}**" in perf, layer


def test_files_under_paths_are_named_from_name_characters():
    for root, dirs, files in os.walk(run.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            assert NAME.match(f), os.path.join(root, f)
