"""``BENCHMARK.json`` against the benchmark's contract and its files."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "bench_h100"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion",
               "experts_per_token")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench_h100/run.py"]
    assert BENCH["paths"] == ["bench_h100"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("bench_h100/configs/")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"] == Path(entry["file"]).stem
    assert cfg["reduced"] == entry["reduced"]
    for key in entry["reduced"]:
        assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
    assert cfg["arch"]["cv_depth_steps"] == cfg["shape"]["depth_steps"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_resolves(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    spec = json.loads((HERE / "workloads" / f"{entry['name']}.json").read_text())
    assert (spec["config"], spec["traffic"], spec["chips"]) == (
        entry["config"], entry["traffic"], entry["chips"])
    assert entry["config"] in {c["name"] for c in BENCH["configs"]}
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    assert (HERE / "kinds" / f"{traffic['kind']}.py").exists()
    assert entry["chips"] in (1, 4)
    assert all(isinstance(v, float) and v > 0 for v in spec["limits"].values())
    assert len(entry["why"]) <= 200


def test_names_units_and_lines():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end", "per_layer")
             for e in BENCH[key]]
    names += [e["config"] for e in BENCH["workloads"]] + [e["traffic"] for e in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    texts = ([e["why"] for e in BENCH["configs"] + BENCH["workloads"]]
             + [e["source"] for e in BENCH["configs"]] + [m["layer"] for m in BENCH["per_layer"]])
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_metrics_resolve():
    from bench_h100 import harness

    readers = harness.metric_readers()
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] in readers and readers[m["name"]].UNIT == m["unit"]
        assert m["moves"] in e2e
        moved = set(e2e[m["moves"]].get("workloads", cells))
        assert set(m["workloads"]) <= moved
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])


@pytest.mark.parametrize("path", sorted((HERE / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_keys_are_read(path):
    """Every key of a mix is one its kind reads, and the kind finds all of
    them: a mix cannot set a knob that no code reads."""
    from bench_h100 import harness

    traffic = json.loads(path.read_text())
    assert set(traffic) - {"kind", "why"} == set(harness.kind_module(traffic).KEYS)


TRAINING_MIXES = [p for p in sorted((HERE / "traffic").glob("*.json"))
                  if "stage" in json.loads(p.read_text())]


@pytest.mark.parametrize("path", TRAINING_MIXES, ids=lambda p: p.stem)
def test_training_stage_resolves(path):
    from bench_h100 import flops
    from bench_h100.kinds import _training

    traffic = json.loads(path.read_text())
    assert traffic["stage"] in _training.STAGES
    assert flops.step_flops(dict(height=32, width=64, depth_steps=8, frames=2),
                            traffic["stage"]) > 0


def test_unread_traffic_key_refused(tmp_path, monkeypatch):
    from bench_h100 import harness

    real = harness.load_json

    def load(*parts):
        out = real(*parts)
        return dict(out, clients=4) if parts[0] == "traffic" else out

    monkeypatch.setattr(harness, "load_json", load)
    with pytest.raises(ValueError, match="clients"):
        harness.Cell.load("kitti-b8-infer")
