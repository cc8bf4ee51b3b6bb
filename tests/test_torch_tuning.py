"""The port's tuning modules against the JAX package's.

The pure decisions (``ladder_pad``, ``shape_bucket``, the ladder, hold
window and slot rules) give the same answers; the store writes the same
bytes and reads them back; the tuner fed the same observations decides
the same bucket ladder, slot count and hold window, and serving's
``bucket_size`` pads to it in both packages.
"""

import json

import pytest
import torch

from mmlspark_tpu import tuning as jtun
from mmlspark_tpu.io import serving as jserving
from mmlspark_tpu.observability import flight as jflight
from mmlspark_tpu.observability import metrics as jmetrics
from mmlspark_tpu.tuning import decisions as jdec
from mmlspark_tpu.tuning import store as jstore
from mmlspark_tpu_torch import tuning as ptun
from mmlspark_tpu_torch.io import serving as pserving
from mmlspark_tpu_torch.observability import flight as pflight
from mmlspark_tpu_torch.observability import metrics as pmetrics
from mmlspark_tpu_torch.tuning import decisions as pdec
from mmlspark_tpu_torch.tuning import store as pstore

torch.set_num_threads(1)

PKGS = ((jtun, jmetrics, jflight, jserving),
        (ptun, pmetrics, pflight, pserving))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MMLSPARK_TPU_TUNING_DIR", raising=False)
    prev = [m.set_enabled(True) for _, m, _, _ in PKGS]
    for tun, m, f, _ in PKGS:
        tun.reset()
        m.reset()
        f.clear()
    yield
    for (tun, m, f, _), was in zip(PKGS, prev):
        tun.reset()
        m.reset()
        f.clear()
        m.set_enabled(was)


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 9, 33, 40, 41, 104, 105,
                               1000])
@pytest.mark.parametrize("ladder", [(1, 2, 4, 8, 40, 104), (1, 16), ()])
def test_ladder_pad_matches(n, ladder):
    assert pdec.ladder_pad(n, ladder) == jdec.ladder_pad(n, ladder)


@pytest.mark.parametrize("shape", [(1, 1, 2), (1000, 28, 255),
                                   (581_012, 54, 63), (1 << 20, 136, 16)])
def test_shape_bucket_matches(shape):
    assert pdec.shape_bucket(*shape) == jdec.shape_bucket(*shape)


COUNTS = [
    {"1": 90, "2": 10},
    {"3": 8, "5": 8, "37": 16, "100": 8},
    {"16": 50, "32": 50},
    {str(i): 1 for i in range(1, 300)},
]


@pytest.mark.parametrize("counts", COUNTS)
@pytest.mark.parametrize("min_samples", [1, 64])
def test_ladder_and_slot_decisions_match(counts, min_samples):
    for fn in (lambda d: d.decide_bucket_ladder(counts, min_samples),
               lambda d: d.decide_slots(counts, 64, min_samples,
                                        row_bytes=112,
                                        headroom_bytes=4096.0),
               lambda d: [d.percentile_from_counts(counts, q)
                          for q in (0.5, 0.9, 0.999, 1.0)]):
        assert fn(pdec) == fn(jdec)


@pytest.mark.parametrize("args", [
    ("memory", 0.0001, 0.004, 3.0, 32, 0.002),
    ("compute", 0.0001, 0.004, 3.0, 32, 0.002),
    ("memory", 0.003, 0.004, 3.0, 32, 0.002),
    ("memory", 0.0001, 0.004, 30.0, 32, 0.002),
    (None, 0.0, 0.0, 0.0, 0, 0.0),
])
def test_hold_window_decision_matches(args):
    assert pdec.decide_hold_window(*args) == jdec.decide_hold_window(*args)


def test_store_round_trip_matches(tmp_path):
    payload = {"format_version": 1,
               "fingerprint": {"device_kind": "k", "model_sha256": None,
                               "framework_version": "x"},
               "evidence": {"batch_counts": {"3": 8, "37": 16}},
               "decisions": {"bucket_ladder": [1, 2, 4, 8, 40, 104]}}
    paths = [s.save_store(str(tmp_path / name), payload)
             for s, name in ((jstore, "jax"), (pstore, "port"))]
    blobs = [open(p).read() for p in paths]
    assert blobs[0] == blobs[1]
    assert pstore.load_store(str(tmp_path / "jax")) == \
        jstore.load_store(str(tmp_path / "port")) == payload
    assert pstore.load_store(str(tmp_path / "empty")) == \
        jstore.load_store(str(tmp_path / "empty"))
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "tuning.json").write_text("{not json")
    for s in (jstore, pstore):
        with pytest.raises(s.StoreError):
            s.load_store(str(tmp_path / "bad"))
    fp = [s.fingerprint_mismatches({"device_kind": "a", "model_sha256": "m"},
                                   {"device_kind": "b", "model_sha256": None})
          for s in (jstore, pstore)]
    assert fp[0] == fp[1]


def _observe(tun, sizes):
    for n in sizes:
        tun.observe_batch_size(n)
        tun.observe_forming_wait(0.0001)
        tun.observe_score(0.004)


def _strip(payload):
    """A tuning payload without the fields that name the package or its
    device (the JAX package reads ``cpu`` from jax, the port none until
    CUDA is up)."""
    out = json.loads(json.dumps(payload))
    out.get("fingerprint", {}).pop("framework_version", None)
    out.get("fingerprint", {}).pop("device_kind", None)
    out.pop("store", None)
    return out


@pytest.mark.parametrize("sizes", [(3, 5, 37, 37, 100) * 8,
                                   (1, 2) * 20, (16, 32) * 20])
def test_tuner_decides_the_same_ladder(monkeypatch, tmp_path, sizes):
    monkeypatch.setenv("MMLSPARK_TPU_TUNE_MIN_SAMPLES", "16")
    monkeypatch.setenv("MMLSPARK_TPU_ASERVE_SLOTS", "auto")
    outs = []
    for (tun, m, f, serving), name in zip(PKGS, ("jax", "port")):
        monkeypatch.setenv("MMLSPARK_TPU_TUNING_DIR", str(tmp_path / name))
        tun.reset()
        tun.note_slot_geometry(112, 64)
        _observe(tun, sizes)
        tun.flush()
        ladder = tun.resolve_bucket_ladder()
        pads = [serving.bucket_size(n, 128) for n in (1, 3, 9, 37, 100,
                                                      120)]
        slots = tun.resolve_slots_auto(64, row_bytes=112)
        hold = tun.resolve_hold_window()
        snap = _strip(tun.snapshot_payload())
        stored = _strip(json.load(open(tmp_path / name / "tuning.json")))
        decided = [
            {k: v for k, v in e.items() if k not in ("ts", "tid")}
            for e in f.events() if e["kind"] == "tuning"]
        outs.append((ladder, pads, slots, hold, snap, stored, decided,
                     m.get_registry().snapshot().get(
                         "tuning_decisions_total")))
        tun.reset()
    assert outs[0] == outs[1]
    if sizes[:2] == (3, 5):
        assert outs[0][0] == (1, 2, 4, 8, 40, 104)
        assert outs[0][1] == [1, 4, 40, 40, 104, 128]


def test_second_process_reads_the_store(monkeypatch, tmp_path):
    """A fresh tuner on a store the first one wrote resolves the same
    ladder without new evidence, in both packages."""
    monkeypatch.setenv("MMLSPARK_TPU_TUNE_MIN_SAMPLES", "16")
    outs = []
    for (tun, _, _, _), name in zip(PKGS, ("jax", "port")):
        monkeypatch.setenv("MMLSPARK_TPU_TUNING_DIR", str(tmp_path / name))
        tun.reset()
        _observe(tun, (3, 5, 37, 37, 100) * 8)
        tun.flush()
        tun.reset()
        outs.append((tun.resolve_bucket_ladder(),
                     tun.provenance()["status"]))
        tun.reset()
    assert outs[0] == outs[1] == ((1, 2, 4, 8, 40, 104), "ok")


def test_disabled_tuning_matches(monkeypatch):
    outs = []
    for tun, _, _, serving in PKGS:
        outs.append((tun.enabled(), tun.resolve_bucket_ladder(),
                     tun.resolve_hold_window(),
                     tun.resolve_slots_auto(32),
                     tun.snapshot_payload()["status"],
                     [serving.bucket_size(n, 32) for n in (1, 3, 17, 40)]))
    assert outs[0] == outs[1]
    assert outs[0][-1] == [1, 4, 32, 32]
