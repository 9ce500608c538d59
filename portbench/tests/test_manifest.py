"""BENCHMARK.json against the files it names and the format's character
rules: every metric has its reader, every cell its traffic, configuration
and limits, every name and unit only the allowed characters."""
import json
import os
import re
import sys
import types

import pytest

from portbench import families

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_every_per_layer_metric_has_its_reader(m):
    assert os.path.exists(os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py"))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for w in m.get("workloads", []):
        cell = next(c for c in BENCH["workloads"] if c["name"] == w)
        e2e = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert cell["name"] in e2e.get("workloads", [cell["name"]])


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda m: m["name"])
def test_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "roofline" in m["name"] or "mfu" in m["name"] or "share" in m["name"]:
        assert m["unit"] == "%"


def test_names_are_unique():
    for group in (ALL_METRICS, BENCH["workloads"], BENCH["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_every_cell_has_its_files_and_metrics(cell):
    here = os.path.join(ROOT, "portbench")
    assert os.path.exists(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    assert os.path.exists(os.path.join(here, "limits", cell["name"] + ".json"))
    assert NAME.match(cell["traffic"]) and cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    e2e = [e["name"] for e in BENCH["end_to_end"] if cell["name"] in e.get("workloads", [cell["name"]])]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert any(cell["name"] in m.get("workloads", [cell["name"]]) and m["moves"] in e2e
               for m in BENCH["per_layer"])


def _config_file(conf) -> dict:
    with open(os.path.join(ROOT, conf["file"])) as f:
        return json.load(f)


def _check_whole(conf, c) -> None:
    """The file is the manifest's configuration, states its own cut, and
    holds its family's published shape (the family's check_config)."""
    assert conf["file"].startswith("portbench/")
    assert c["source"] == conf["source"]
    assert conf["reduced"] == c["reduced"]
    assert all(k in c for k in c["reduced"])
    families.load(c).check_config(c)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_is_whole(conf):
    _check_whole(conf, _config_file(conf))


def _failing(c):
    raise ValueError("not the published shape")


@pytest.mark.parametrize("change,error", [
    ({"family": "failing_check"}, ValueError),          # the family's check_config fails
    ({"reduced": ["no_such_key"]}, AssertionError),     # a cut of a key the file lacks
    ({"encoder_ffn_dim": 4000}, ValueError),            # Whisper's own shape broken
], ids=["family_check_config", "reduced_key", "whisper_shape"])
def test_a_configuration_that_is_not_whole_fails(monkeypatch, change, error):
    monkeypatch.setitem(sys.modules, "portbench.family_failing_check",
                        types.SimpleNamespace(check_config=_failing))
    conf = BENCH["configs"][0]
    c = dict(_config_file(conf), **change)
    conf = dict(conf, reduced=c["reduced"])
    with pytest.raises(error):
        _check_whole(conf, c)


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_the_port_builds_the_configuration_as_stated(conf):
    c = _config_file(conf)
    assert families.load(c).port_matches(c)
