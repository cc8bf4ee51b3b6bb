"""The harness finds every piece by the name BENCHMARK.json gives, and a
cell, configuration, mix and metric added as new files and entries run
with no file of the harness edited."""

import json
import os
import shutil

import pytest

from perfbench import harness


def test_every_named_piece_exists(bench):
    spec = bench.spec
    for cell in spec["workloads"]:
        cfg = bench.config(cell["config"])
        mix = bench.traffic(cell["traffic"])
        assert cfg["name"] == cell["config"]
        assert os.path.isfile(os.path.join(bench.dir, "drivers",
                                           mix["driver"] + ".py"))
        assert os.path.isfile(os.path.join(
            bench.dir, "datagen", cfg["data"]["generator"] + ".py"))
        assert bench.limits(cell["name"])
        reported = bench.metrics_of("end_to_end", cell["name"])
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert bench.metrics_of("per_layer", cell["name"])
    for m in spec["per_layer"]:
        assert callable(bench.reader(m["name"]).read)


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        bench.cell("no-such-cell")
    with pytest.raises(KeyError):
        bench.config("no-such-config")


def test_a_cell_added_as_files_runs(bench, tiny_run, tmp_path):
    """A copy of the benchmark gains a configuration (Covertype's shape, 7
    classes, on the generator already there), a mix, a limits file, a
    metric reader and the entries naming them: the new cell runs, agrees
    with the reference and reports the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(bench.dir, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads(json.dumps(bench.spec))
    d = root / "perfbench"
    cfg = json.loads((d / "configs" / "higgs-binary-qgrad.json").read_text())
    cfg["name"] = "covtype-multiclass"
    cfg["params"]["objective"] = "multiclass"
    cfg["objective"] = {"name": "multiclass", "num_class": 7,
                        "hessian_factor": 2.0, "init_score": "zero"}
    cfg["data"]["generator"] = "covertype_shaped"
    (d / "configs" / "covtype-multiclass.json").write_text(json.dumps(cfg))
    (d / "traffic" / "fit-warm.json").write_text(json.dumps(
        {"driver": "fit", "warmup_iterations": 1, "cold_cache": False}))
    (d / "limits" / "covtype-fit.json").write_text(
        (d / "limits" / "higgs-qgrad-fit.json").read_text())
    (d / "metrics" / "fits_in_window.py").write_text(
        "def read(run):\n    return float(len(run.layer['fits']))\n")
    spec["configs"].append({
        "name": "covtype-multiclass", "source": "test", "reduced": [],
        "file": "perfbench/configs/covtype-multiclass.json", "why": "test"})
    spec["workloads"].append({"name": "covtype-fit",
                              "config": "covtype-multiclass",
                              "traffic": "fit-warm", "chips": 1,
                              "why": "test"})
    spec["end_to_end"][0]["workloads"].append("covtype-fit")
    spec["per_layer"].append({"name": "fits_in_window", "unit": "fits",
                              "better": "higher", "source": "host_clock",
                              "layer": "estimator", "moves": "fit_s",
                              "workloads": ["covtype-fit"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    added = harness.Bench(str(root))
    r = tiny_run("covtype-fit", on=added, trace=True)
    assert r["correct"], r["checks"]
    assert r["metrics"]["fits_in_window"]["value"] >= 1
    r = tiny_run("covtype-fit", on=added)
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"fit_s", "setup_s"}
