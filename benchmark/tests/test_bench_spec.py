"""Every configuration, mix and reader loads by its name, BENCHMARK.json
keeps to its contract's shape, and a cell made only of new files runs
without any change to the harness."""

import json
import os
import re
import textwrap

import pytest

from conftest import ROOT
from harness import cell as cell_mod
from harness import spec

BENCH_JSON = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload",
                         [w["name"] for w in BENCH_JSON["workloads"]])
def test_every_file_of_a_cell_loads_by_name(workload):
    c = spec.load(workload)
    assert callable(c.entry.Workload) and callable(c.entry.check)
    assert callable(c.entry.metrics)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert callable(c.reader(m["name"]))


def test_benchmark_json_shape():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    cells = 24
    assert (2 + 14 * cells) * (b["run_seconds"] + 60) + cells * 180 \
        + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert not any(k.endswith(("_dim", "_rank")) for k in c["reduced"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["traffic"])
        used.add(w["config"])
    assert used == configs
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) < 64 * 1024


def _throwaway(root):
    """A cell, its configuration, mix (with a generator and an open-loop
    schedule of its own), entry and reader, all new files."""
    bench = os.path.join(root, "benchmark")
    for d in ("configs", "traffic", "generators", "schedules", "entries",
              "layers"):
        os.makedirs(os.path.join(bench, d))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump({
            "configs": [{"name": "toy", "file": "benchmark/configs/toy.json"}],
            "workloads": [{"name": "toy.sum", "config": "toy",
                           "traffic": "words", "chips": 1}],
            "end_to_end": [
                {"name": "words_per_s", "unit": "words/s"},
                {"name": "setup_s", "unit": "s"}],
            "per_layer": [{"name": "units.toy", "unit": "n",
                           "moves": "words_per_s"}]}, f)
    with open(os.path.join(bench, "configs", "toy.json"), "w") as f:
        json.dump({"entry": "toy"}, f)
    with open(os.path.join(bench, "traffic", "words.json"), "w") as f:
        json.dump({"generator": "words", "schedule": "paced",
                   "shape": [3, 5], "every_s": 0.05}, f)
    with open(os.path.join(bench, "generators", "words.py"), "w") as f:
        f.write(textwrap.dedent('''
            def make(mix, rng, base, warm):
                return [rng.integers(0, 2**40, mix["shape"], dtype="uint64")]
            '''))
    with open(os.path.join(bench, "schedules", "paced.py"), "w") as f:
        f.write(textwrap.dedent('''
            import time
            from harness.window import Window

            def run(work, rounds, seconds, device, mix):
                w = Window()
                w.start = time.perf_counter()
                while time.perf_counter() - w.start < seconds:
                    for unit in next(rounds):
                        due = w.start + w.attempted * mix["every_s"]
                        time.sleep(max(0.0, due - time.perf_counter()))
                        w.attempted += 1
                        t0 = time.perf_counter()
                        w.done.append((unit, work.prove(unit), t0,
                                       time.perf_counter()))
                w.end = time.perf_counter()
                return w
            '''))
    with open(os.path.join(bench, "entries", "toy.py"), "w") as f:
        f.write(textwrap.dedent('''
            def metrics(work, units, seconds):
                return {"words_per_s": work / seconds}

            class Workload:
                def __init__(self, config, device):
                    pass
                def setup(self, warm):
                    pass
                def prove(self, words):
                    return int(words.sum(dtype="uint64") % 7)
                def work(self, words):
                    return float(words.size)
                def answers(self, done):
                    return [(w, out) for w, out, _, _ in done]

            def check(answers, seed, device):
                wrong = sum(int(w.sum(dtype="uint64") % 7) != out
                            for w, out in answers)
                return {"sums_wrong": wrong}
            '''))
    with open(os.path.join(bench, "layers", "units.py"), "w") as f:
        f.write("def read(trace):\n    return float(trace.units)\n")


@pytest.mark.parametrize("trace", [False, True])
def test_a_throwaway_cell_runs_through_the_unchanged_harness(tmp_path,
                                                             trace):
    _throwaway(str(tmp_path))
    c = spec.load("toy.sum", root=str(tmp_path))
    out = cell_mod.run(c, 2**40 + 3, 0.2, trace, "cpu", 0.0)
    correct, checked = cell_mod.verdict(out["counts"])
    assert correct and checked["sums_wrong"] == {"value": 0, "limit": 0}
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        assert out["metrics"]["units.toy"]["value"] == out["attempted"]
        assert out["device"]["window_s"] >= 0.2
    else:
        assert set(out["metrics"]) == {"words_per_s", "setup_s"}
