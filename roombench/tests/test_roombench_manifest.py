"""BENCHMARK.json's names, units and cross references."""

import copy

import pytest

from roombench import harness, manifest


@pytest.fixture()
def bm():
    return manifest.load(harness.ROOT)


def test_manifest_is_valid_and_finds_its_cells(bm):
    for w in bm["workloads"]:
        cell, cfg = manifest.cell(bm, w["name"])
        assert cfg["name"] == w["config"]
        e2e = manifest.metrics_for(bm, w["name"], trace=False)
        names = {x["name"] for x in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert manifest.metrics_for(bm, w["name"], trace=True)


@pytest.mark.parametrize("path,value", [
    (("per_layer", 0, "unit"), "micro seconds"),
    (("per_layer", 0, "name"), "bad name"),
    (("end_to_end", 0, "better"), "more"),
    (("end_to_end", 0, "source"), "program_span"),
    (("per_layer", 0, "moves"), "no_such_metric"),
    (("workloads", 0, "config"), "no_such_config"),
    (("workloads", 0, "chips"), 2),
    (("per_layer", 0, "workloads"), ["no.such.cell"]),
])
def test_bad_entries_are_refused(bm, path, value):
    bad = copy.deepcopy(bm)
    x = bad
    for k in path[:-1]:
        x = x[k]
    x[path[-1]] = value
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad)


def test_extra_keys_are_refused(bm):
    bad = copy.deepcopy(bm)
    bad["per_layer"][0]["why"] = "no such key"
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad)
