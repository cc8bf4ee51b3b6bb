"""Serving bundles of the port (``mmlspark_tpu_torch/bundles``): the
non-slow cases of ``tests/test_bundles.py`` on port bundles built and
prewarmed on the CPU, the CLI, and a JAX package bundle refused on its
fingerprint.

A port bundle pins predict plans (a CUDA graph cannot be serialized); a
prewarm recomputes every key from the live model, checks it against the
plan file, prepares the program (on ``cuda`` it captures the graph) and
installs it, so the first predict meets no ``compile`` event. On the CPU a
program runs eagerly and its preparation is empty; the contract — keys,
checksums, fingerprints, the loud degradation, zero compile events after
a prewarm — is the same.
"""

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.bundles import (BundleError, build_bundle,
                                        model_hash, prewarm, read_manifest)
from mmlspark_tpu_torch.bundles.__main__ import main as bundles_main
from mmlspark_tpu_torch.bundles.bundle import MANIFEST_NAME
from mmlspark_tpu_torch.models.gbdt.booster import (Booster, _PREDICT_CACHE,
                                                    predict_key_manifest,
                                                    preload_predict_program,
                                                    train_booster)
from mmlspark_tpu_torch.models.gbdt.growth import GrowConfig
from mmlspark_tpu_torch.observability import flight, metrics

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A tiny port booster saved as model.txt (its JSON model string, which
    the JAX package reads too) and a bundle built from it."""
    d = tmp_path_factory.mktemp("torch_bundles")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 6)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] > 0).astype(np.float32)
    booster = train_booster(X=X, y=y, num_iterations=3, objective="binary",
                            cfg=GrowConfig(num_leaves=7, min_data_in_leaf=5),
                            device="cpu")
    (d / "model.txt").write_text(booster.model_string())
    build_bundle(str(d / "model.txt"), str(d / "model.bundle"), max_batch=8,
                 device="cpu")
    return d


def _load(model_dir):
    return Booster.from_string((model_dir / "model.txt").read_text())


def _fresh_start():
    """A fresh process, as far as predict sees: empty cache and ring."""
    _PREDICT_CACHE.clear()
    flight.clear()


def _compile_events():
    return [e for e in flight.events() if e.get("kind") == "compile"]


def _prewarm(model_dir, bundle, b):
    return prewarm(str(model_dir / "model.txt"), str(bundle), boosters=[b],
                   device="cpu")


class TestBuild:
    def test_manifest_shape_and_checksums(self, model_dir):
        man = read_manifest(model_dir / "model.bundle")
        assert man["format_version"] == 1
        assert man["model"]["sha256"] == model_hash(
            str(model_dir / "model.txt"))
        # pow2 ladder 1, 2, 4, 8: four distinct programs
        assert len(man["entries"]) == 4
        for e in man["entries"]:
            p = os.path.join(model_dir / "model.bundle",
                             *e["file"].split("/"))
            assert os.path.exists(p)
            assert e["sha256"] and e["size_bytes"] == os.path.getsize(p)
            plan = json.loads(open(p).read())
            assert plan["n_pad"] == e["n_pad"] and plan["t_pad"] == 3
        fp = man["fingerprint"]
        assert fp["device_name"] == "cpu"
        assert fp["model_sha256"] == man["model"]["sha256"]
        for k in ("torch_version", "framework_version"):
            assert fp[k]
        assert {"cuda_runtime", "compute_capability"} <= set(fp)

    def test_key_manifest_matches_build(self, model_dir):
        b = _load(model_dir)
        man = read_manifest(model_dir / "model.bundle")
        expected = {e["key_hash"]
                    for e in predict_key_manifest(b, [1, 2, 4, 8])}
        assert {e["key_hash"] for e in man["entries"]} == expected

    def test_pow2_aliasing_dedupes(self, model_dir):
        b = _load(model_dir)
        man = predict_key_manifest(b, [3, 4])
        assert len(man) == 1 and man[0]["n_pad"] == 4

    def test_refuses_existing_dir_without_force(self, model_dir):
        with pytest.raises(BundleError):
            build_bundle(str(model_dir / "model.txt"),
                         str(model_dir / "model.bundle"), device="cpu")

    def test_atomic_no_tmp_left_behind(self, model_dir):
        assert [n for n in os.listdir(model_dir) if ".tmp-" in n] == []

    def test_cli_build_and_inspect(self, model_dir, tmp_path, capsys):
        out = tmp_path / "cli.bundle"
        assert bundles_main(["build", "--model",
                             str(model_dir / "model.txt"), "--out", str(out),
                             "--max-batch", "4", "--predict-dtypes",
                             "f32,int8", "--device", "cpu"]) == 0
        man = read_manifest(out)
        assert {e["predict_dtype"] for e in man["entries"]} == {"f32",
                                                                "int8"}
        assert len(man["entries"]) == 6
        capsys.readouterr()
        assert bundles_main(["inspect", str(out)]) == 0
        assert json.loads(capsys.readouterr().out)["entries"] == \
            man["entries"]


class TestPrewarm:
    def test_zero_compile_and_bit_identical_numerics(self, model_dir):
        b = _load(model_dir)
        Xq = np.random.default_rng(1).normal(size=(5, 6)).astype(np.float32)
        _fresh_start()
        p_cold = b.predict(Xq, device="cpu")
        assert len(_compile_events()) == 1
        _fresh_start()
        stats = _prewarm(model_dir, model_dir / "model.bundle", b)
        assert stats["status"] == "ok" and stats["entries_loaded"] == 4
        loaded = [e for e in flight.events() if e.get("kind") == "bundle"
                  and e.get("event") == "entry_loaded"]
        assert len(loaded) == 4 and not any(e["graph"] for e in loaded)
        flight.clear()
        p_warm = b.predict(Xq, device="cpu")
        assert _compile_events() == []
        assert np.array_equal(p_warm, p_cold)

    def test_preload_never_clobbers(self, model_dir):
        b = _load(model_dir)
        _fresh_start()
        b.predict(np.zeros((2, 6), np.float32), device="cpu")
        plan = b.predict_plan(2)
        live = _PREDICT_CACHE[("cpu", plan.key)]
        assert preload_predict_program(plan.key, lambda *a: None,
                                       device="cpu") is False
        assert _PREDICT_CACHE[("cpu", plan.key)] is live

    def test_fingerprint_mismatch_degrades_loudly(self, model_dir,
                                                  tmp_path):
        skewed = tmp_path / "skewed.bundle"
        shutil.copytree(model_dir / "model.bundle", skewed)
        man = json.loads((skewed / MANIFEST_NAME).read_text())
        man["fingerprint"]["torch_version"] = "9.9.9"
        (skewed / MANIFEST_NAME).write_text(json.dumps(man))
        b = _load(model_dir)
        _fresh_start()
        before = metrics.counter("bundle_loads_total",
                                 status="fingerprint_mismatch").value
        stats = _prewarm(model_dir, skewed, b)
        assert stats["status"] == "fingerprint_mismatch"
        assert stats["entries_loaded"] == 0
        assert metrics.counter("bundle_loads_total",
                               status="fingerprint_mismatch"
                               ).value == before + 1
        ev = [e for e in flight.events() if e.get("kind") == "bundle"
              and e.get("event") == "fingerprint_mismatch"]
        assert ev and any("torch_version" in m for m in ev[0]["mismatches"])
        assert len(_PREDICT_CACHE) == 0
        Xq = np.ones((3, 6), np.float32)
        p = b.predict(Xq, device="cpu")
        _PREDICT_CACHE.clear()
        assert np.array_equal(p, b.predict(Xq, device="cpu"))

    def test_model_skew_degrades(self, model_dir, tmp_path):
        reser = tmp_path / "reser.txt"
        reser.write_text(json.dumps(
            json.loads((model_dir / "model.txt").read_text()), indent=1))
        b = Booster.from_string(reser.read_text())
        _fresh_start()
        stats = prewarm(str(reser), str(model_dir / "model.bundle"),
                        boosters=[b], device="cpu")
        assert stats["status"] == "fingerprint_mismatch"

    def test_corrupt_program_skipped_rest_load(self, model_dir, tmp_path):
        corrupt = tmp_path / "corrupt.bundle"
        shutil.copytree(model_dir / "model.bundle", corrupt)
        man = json.loads((corrupt / MANIFEST_NAME).read_text())
        victim = os.path.join(corrupt, *man["entries"][0]["file"].split("/"))
        blob = bytearray(open(victim, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        with open(victim, "wb") as f:
            f.write(blob)
        b = _load(model_dir)
        _fresh_start()
        stats = _prewarm(model_dir, corrupt, b)
        assert (stats["status"], stats["entries_loaded"],
                stats["entries_skipped"]) == ("ok", 3, 1)
        skipped = [e for e in flight.events() if e.get("kind") == "bundle"
                   and e.get("event") == "entry_skipped"]
        assert skipped and skipped[0]["reason"] == "checksum_mismatch"

    def test_malformed_entry_degrades(self, model_dir, tmp_path):
        bad = tmp_path / "badentry.bundle"
        shutil.copytree(model_dir / "model.bundle", bad)
        man = json.loads((bad / MANIFEST_NAME).read_text())
        del man["entries"][0]["batch_size"]
        man["entries"][1]["num_iteration"] = "not-a-number"
        (bad / MANIFEST_NAME).write_text(json.dumps(man))
        b = _load(model_dir)
        _fresh_start()
        stats = _prewarm(model_dir, bad, b)
        assert (stats["status"], stats["entries_loaded"],
                stats["entries_skipped"]) == ("ok", 2, 2)
        reasons = {e["reason"] for e in flight.events()
                   if e.get("kind") == "bundle"
                   and e.get("event") == "entry_skipped"}
        assert reasons == {"malformed_entry"}

    def test_torn_manifest_degrades(self, model_dir, tmp_path):
        torn = tmp_path / "torn.bundle"
        shutil.copytree(model_dir / "model.bundle", torn)
        full = (torn / MANIFEST_NAME).read_text()
        (torn / MANIFEST_NAME).write_text(full[:len(full) // 2])
        b = _load(model_dir)
        _fresh_start()
        assert _prewarm(model_dir, torn, b)["status"] == "corrupt"
        assert _prewarm(model_dir, tmp_path / "nope.bundle",
                        b)["status"] == "corrupt"


def test_jax_bundle_is_refused_on_its_fingerprint(model_dir, tmp_path):
    from mmlspark_tpu.bundles import build_bundle as jbuild
    jbundle = tmp_path / "jax.bundle"
    jbuild(str(model_dir / "model.txt"), str(jbundle), batch_sizes=[1, 2])
    b = _load(model_dir)
    _fresh_start()
    stats = _prewarm(model_dir, jbundle, b)
    assert stats["status"] == "fingerprint_mismatch"
    ev = [e for e in flight.events() if e.get("kind") == "bundle"
          and e.get("event") == "fingerprint_mismatch"]
    assert ev and any("jax_version" in m for m in ev[0]["mismatches"])
    assert len(_PREDICT_CACHE) == 0
    # it degrades and serves correctly: the predictions are the JAX
    # package's on the same model
    from mmlspark_tpu.models.gbdt.booster import Booster as JBooster
    jb = JBooster.from_string((model_dir / "model.txt").read_text())
    Xq = np.random.default_rng(2).normal(size=(2, 6)).astype(np.float32)
    np.testing.assert_allclose(b.predict(Xq, device="cpu"), jb.predict(Xq),
                               rtol=0, atol=1e-6)


def test_healthz_carries_ready_flag():
    from mmlspark_tpu_torch.io.serving import (healthz_payload, is_ready,
                                               set_ready)
    assert is_ready()
    try:
        set_ready(False)
        assert healthz_payload()["ready"] is False
        assert metrics.gauge("serving_ready").value == 0.0
    finally:
        set_ready(True)
    assert healthz_payload()["ready"] is True


@pytest.mark.parametrize("engine", ["threaded", "async"])
def test_warm_start_zero_compiles(model_dir, engine):
    """Both engines serve their first predict after a prewarm with zero
    compile events, answering /healthz ready."""
    from mmlspark_tpu_torch.io.serving import serve
    b = _load(model_dir)
    _fresh_start()
    assert _prewarm(model_dir, model_dir / "model.bundle",
                    b)["status"] == "ok"

    def transform(ds):
        rows = np.asarray([v["features"] for v in ds["value"]], np.float32)
        preds = b.predict(rows, device="cpu")
        return ds.with_column("reply", [
            {"entity": {"prediction": float(p)}, "statusCode": 200}
            for p in preds])

    flight.clear()
    q = (serve().address("localhost", 0, "bwarm")
         .batch(max_batch=8, max_latency_ms=5)
         .engine(engine).transform(transform).start())
    try:
        body = json.dumps({"features": [0.1] * 6}).encode()
        req = urllib.request.Request(q.server.url, data=body, method="POST")
        with urllib.request.urlopen(req, timeout=10) as r:
            assert r.status == 200
            got = json.loads(r.read())["prediction"]
        assert got == float(b.predict(np.full((1, 6), 0.1, np.float32),
                                      device="cpu")[0])
        hz = urllib.request.urlopen(
            f"http://{q.server.host}:{q.server.port}/healthz", timeout=10)
        assert json.loads(hz.read())["ready"] is True
        assert _compile_events() == [], _compile_events()
    finally:
        q.stop()
