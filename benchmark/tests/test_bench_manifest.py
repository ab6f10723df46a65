"""BENCHMARK.json keeps to its contract, and every name it holds is found
on disk."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import manifest, traffic

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|"
                   r"projection|head|expansion|experts_per_tok|channels")


@pytest.fixture(scope="module")
def m():
    return manifest.load()


def test_keys_and_names(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(m["command"]) <= 32
    for word in m["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word
        assert not word.startswith("/") and ".." not in word
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in m[key]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for e in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")


def test_configs(m):
    assert 1 <= len(m["configs"]) <= 24
    files = [c["file"] for c in m["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        assert (manifest.ROOT.parent / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text


def test_workloads(m):
    configs = {c["name"] for c in m["configs"]}
    pairs = set()
    fours = 0
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        fours += w["chips"] == 4
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic.load(w["traffic"])
    assert fours <= max(1, len(m["workloads"]) // 4)


def test_end_to_end(m):
    names = {e["name"] for e in m["end_to_end"]}
    assert "setup_s" in names
    for e in m["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0 < e["bound"] <= 0.25
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        reported = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer


def test_per_layer_cells_report_what_they_move(m):
    e2e = {e["name"]: e for e in m["end_to_end"]}
    cells = {w["name"] for w in m["workloads"]}
    layers = {}
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert p["moves"] in e2e
        assert 1 <= len(p["layer"]) <= 200 and "\n" not in p["layer"]
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(p["layer"].lower(), set()).add(p["layer"])
        for cell in p.get("workloads", cells):
            assert cell in cells
            moved = e2e[p["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
        if p["name"].endswith("_roofline") or "mfu" in p["name"] \
                or "_roofline." in p["name"]:
            assert p["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader(m):
    for e in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(e["name"]))


def test_every_cell_has_limits_and_a_traffic_file(m):
    from benchmark import check
    for w in m["workloads"]:
        lim = check.limits(w["name"])
        assert lim and all(v >= 0 for v in lim.values())


def test_size_and_budget(m):
    assert len(json.dumps(m).encode()) <= 64 * 1024
    cells = 24                          # what later PRs may grow to
    runs = 2 + 14 * cells
    assert runs * (m["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_every_config_names_its_reference_and_program(m):
    """The reference module, the program's model and every field the
    program's settings are read from exist; no setting is given twice."""
    from benchmark import drivers, reference
    for w in m["workloads"]:
        cell = manifest.cell(w["name"], m)
        cfg = cell.config
        ref = reference.of(cfg)
        for name in ("build", "exact_f32", "state_keys", "seeded_state",
                     "set_generator", "optimizer", "train_step", "logits",
                     "answers"):
            assert callable(getattr(ref, name)), (cfg["reference"], name)
        port = cfg["port"]
        assert set(port) == {"entry", "runtime", "model", "from_config",
                             "set"}
        assert port["model"]["registry"]
        assert not set(port["set"]) & set(port["from_config"])
        overrides = drivers.port_overrides(cfg, cell.mix)
        for key, path in port["from_config"].items():
            assert overrides[key] == drivers.config_value(cfg, path)


def test_every_mix_has_a_driver(m):
    from benchmark import drivers
    for w in m["workloads"]:
        mode = drivers.mode(traffic.load(w["traffic"]))
        assert callable(mode.Driver.check) and callable(mode.control)
