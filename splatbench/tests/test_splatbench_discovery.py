"""The harness finds configurations, mixes, traffic kinds, limits and
metric readers by name, so that a later change adds them as files and
manifest entries."""

import json
import re
import shutil

import pytest
import torch

from splatbench import harness, run

# a traffic kind of its own, as a later change would add it: a runner
# that renders nothing and reports three frames
STILL_RUNNER = """
from splatbench import drive, harness


def run(cell):
    frames = int(cell.traffic["frames"])
    return drive.Outcome(
        run=harness.Run(frames=frames, window_s=0.03 * frames,
                        latencies_s=[0.03] * frames),
        attempted=frames, failed=0, numbers={"img_max_abs": 0.0},
        peak_bytes=0)


def readings(cell, out, control):
    return [dict(kind="sound", seed=cell.seed, **out.numbers)]
"""

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def copy_root(tmp_path):
    src = harness.Bench().root
    shutil.copy(src / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(src / "splatbench", tmp_path / "splatbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def test_new_config_mix_limits_and_metric_are_found(copy_root):
    d = copy_root / "splatbench"
    cfg = json.loads((d / "configs" / "random-1m.json").read_text())
    cfg["scene"]["n"] = 4_000_000
    (d / "configs" / "random-4m.json").write_text(json.dumps(cfg))
    mix = json.loads((d / "traffic" / "orbit.json").read_text())
    mix["frames_per_turn"] = 250
    (d / "traffic" / "orbit-fast.json").write_text(json.dumps(mix))
    (d / "limits" / "random-4m-orbit-fast.json").write_text(
        json.dumps({"limits": {"img_max_abs": 0.5, "img_mse": 1e-6}}))
    (d / "metrics" / "frames_done.py").write_text(
        "def read(run):\n    return run.frames or None\n")
    man = json.loads((copy_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "random-4m-orbit-fast",
                             "config": "random-4m", "traffic": "orbit-fast",
                             "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "frames_done", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "device", "moves": "frame_ms",
                             "workloads": ["random-4m-orbit-fast"]})
    (copy_root / "BENCHMARK.json").write_text(json.dumps(man))

    bench = harness.Bench(copy_root)
    w = bench.workload("random-4m-orbit-fast")
    assert bench.config(w["config"])["scene"]["n"] == 4_000_000
    assert bench.traffic(w["traffic"])["frames_per_turn"] == 250
    assert bench.limits(w["name"])["limits"]["img_mse"] == 1e-6
    run = harness.Run(frames=7, window_s=1.0, latencies_s=[0.1] * 7)
    got = harness.read_metrics(bench, w["name"], True, run)
    assert got["frames_done"] == {"value": 7.0, "unit": "frames"}
    # the end-to-end metrics without a workloads list reach it too
    e2e = harness.read_metrics(bench, w["name"], False, run)
    assert set(e2e) == {"setup_s"}


def test_new_traffic_kind_runs_from_files_alone(copy_root, monkeypatch,
                                               capsys):
    d = copy_root / "splatbench"
    (d / "runners" / "still.py").write_text(STILL_RUNNER)
    (d / "traffic" / "still.json").write_text(
        json.dumps({"kind": "still", "frames": 3}))
    (d / "limits" / "random-1m-still.json").write_text(
        json.dumps({"limits": {"img_max_abs": 0.02}}))
    man = json.loads((copy_root / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "random-1m-still", "config": "random-1m",
                             "traffic": "still", "chips": 1, "why": "test"})
    for m in man["end_to_end"]:
        if m["name"] in ("frame_ms", "frame_p95_ms"):
            m["workloads"].append("random-1m-still")
    (copy_root / "BENCHMARK.json").write_text(json.dumps(man))

    # the run's look for a card passes; the stub runner needs none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "stub")
    code = run.main(["--workload", "random-1m-still", "--seed", "7",
                     "--seconds", "1", "--trace", "0"], root=copy_root)
    assert code == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] == 3
    assert line["metrics"]["frame_ms"]["value"] == pytest.approx(30.0)
    assert set(line["metrics"]) == {"frame_ms", "frame_p95_ms", "setup_s"}
    assert list(line)[-1] == "checks"


def test_missing_file_is_refused(copy_root):
    bench = harness.Bench(copy_root)
    with pytest.raises(FileNotFoundError):
        bench.config("no-such-config")
    with pytest.raises(KeyError):
        bench.workload("no-such-cell")
    with pytest.raises(FileNotFoundError):
        bench.runner("no-such-kind")


def test_every_manifest_entry_has_its_files():
    bench = harness.Bench()
    man = bench.manifest
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (bench.root / c["file"]).is_file()
        assert bench.config(c["name"])["name"] == c["name"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
        bench.config(w["config"])
        runner = bench.runner(bench.traffic(w["traffic"])["kind"])
        assert callable(runner.run) and callable(runner.readings)
        assert bench.limits(w["name"])["limits"]
    names = set()
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names
        names.add(m["name"])
        assert callable(bench.reader(m["name"]))
    for m in man["per_layer"]:
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    for w in man["workloads"]:
        traced = {m["name"] for m in bench.metrics(w["name"], True)}
        untraced = {m["name"] for m in bench.metrics(w["name"], False)}
        assert "setup_s" in untraced and len(untraced) >= 2 and traced
