"""The harness finds a cell's configuration, mix and per-layer metrics by
the names in BENCHMARK.json alone: a later change adds a mix and a metric
as files and entries, and edits no code. Shown in a temporary copy of the
benchmark."""

import json
import os
import shutil
import subprocess
import sys

from perfbench import harness


def test_a_new_mix_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(harness.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.benchmark()
    bench["workloads"].append({
        "name": "c2_gru_4bar.train-tiny", "config": "c2_gru_4bar",
        "traffic": "train-tiny", "chips": 1, "why": "a throwaway cell"})
    bench["per_layer"].append({
        "name": "steps.tiny", "unit": "steps", "better": "higher",
        "source": "program_counter", "layer": "train loop",
        "moves": "train_bars_per_s", "workloads": ["c2_gru_4bar.train-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = harness.load_json(os.path.join(harness.BENCH, "mixes",
                                         "train-resident.json"))
    (root / "perfbench" / "mixes" / "train-tiny.json").write_text(
        json.dumps(dict(mix, pieces=2)))
    (root / "perfbench" / "metrics" / "steps.tiny.py").write_text(
        "def read(run):\n    return float(run.trace['steps'])\n")
    code = (
        "import sys; sys.path.insert(0, '.')\n"
        "from perfbench import harness\n"
        "b = harness.benchmark()\n"
        "w, spec, mix = harness.cell(b, 'c2_gru_4bar.train-tiny')\n"
        "assert mix['pieces'] == 2 and spec['name'] == 'c2_gru_4bar'\n"
        "names = [m['name'] for m in harness.layer_metrics(b, w['name'])]\n"
        "assert names == ['steps.tiny'], names\n"
        "run = harness.TraceRun(harness.Ctx(w['name'], spec, mix, 1, 1, True),"
        " {'steps': 7})\n"
        "print(harness.reader('steps.tiny')(run))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "7.0"


def test_every_cell_resolves_and_lists_its_metrics():
    bench = harness.benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        _, spec, mix = harness.cell(bench, w["name"])
        assert spec["name"] == w["config"]
        assert os.path.exists(os.path.join(harness.BENCH, "runners",
                                           mix["runner"] + ".py"))
        reported = {m["name"] for m in harness.end_to_end_metrics(
            bench, w["name"])}
        assert "setup_s" in reported and len(reported & e2e) >= 2
        layer = harness.layer_metrics(bench, w["name"])
        assert layer and all(m["moves"] in reported for m in layer)
        for m in layer:
            assert callable(harness.reader(m["name"]))


def test_a_run_outside_a_checkout_of_the_program_fails(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "c2_gru_4bar.train-resident", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0 and not out.stdout.strip()
