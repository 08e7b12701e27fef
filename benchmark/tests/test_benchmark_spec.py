"""BENCHMARK.json against the contract's shape: keys, names, units,
lengths, and that every named file is there."""

import json
import re

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec():
    return harness.load_spec()


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    raw = (harness.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    s = json.loads(raw)
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(s["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32
    assert all(one_line(w) and not w.startswith("/") for w in s["command"])
    assert 1 <= s["run_seconds"] <= 51


def test_names_units_and_entries():
    s = spec()
    names = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert (harness.ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in s["paths"]))
        names.add(("config", c["name"]))
    pairs = set()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and one_line(w["why"])
        assert ("config", w["config"]) in names
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (harness.HERE / "mixes" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    cells = {w["name"] for w in s["workloads"]}
    metric_names = set()
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert set(m.get("workloads", cells)) <= cells
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in s["end_to_end"]}
    assert "setup_s" in e2e
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    s = spec()
    for w in s["workloads"]:
        e2e = [m["name"] for m in s["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [m for m in s["per_layer"]
                 if w["name"] in m.get("workloads", [w["name"]])]
        assert layer and all(m["moves"] in e2e for m in layer)


def test_configs_load_into_options():
    from unsupervised_pose_estimation_tpu_torch.config import Options

    from benchmark.traffic import train_loop

    for c in spec()["configs"]:
        cfg = harness.config(c["name"])
        opt = train_loop.options(cfg)
        assert isinstance(opt, Options)
        assert opt.compute_dtype in ("bfloat16", "float32")
        assert cfg["tf32"] is False and cfg["reduced"] == c["reduced"]
