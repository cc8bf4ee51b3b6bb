"""Serving bundles: a worker that comes up warm.

The port's copy of ``mmlspark_tpu/bundles/bundle.py``. A worker restart
pays one capture per predict program before its first reply; a bundle
moves that work before the worker binds. The JAX package serializes
AOT-lowered executables; a CUDA graph cannot be serialized, so a port
bundle pins the plans instead and the worker captures them at start:

Offline half (:func:`build_bundle` / ``python -m mmlspark_tpu_torch.bundles
build``): load the model, enumerate the predictor cache keys its batch and
tree buckets dispatch to (:func:`...booster.iter_predict_plans` — the SAME
key computation the serving path uses), and write an atomic, versioned,
checksummed bundle directory: ``MANIFEST.json`` and one ``programs/
<key_hash>.json`` per plan (its key ``repr``, ``n_pad``, ``T_pad``,
``num_features`` and lane), each with its sha256 in the manifest.

Online half (:func:`prewarm`, wired into ``serving_main worker --bundle``
/ ``MMLSPARK_TPU_BUNDLE_DIR``): verify the manifest, the per-file
checksums and :func:`runtime_fingerprint` (torch version, CUDA runtime,
device name, compute capability, model hash), then capture every entry's
graph against the live model and install it with
``preload_predict_program`` before the worker binds. The first request
then takes the cache-hit path.

A defective bundle (torn, skewed, for another model or another card) is a
LOUD structured warning plus online capture on first use — never a
silent load: programs install only under keys recomputed from the live
model, so a stale bundle cannot be consulted for a model it was not built
from, and the numerics are the same either way.

The JAX bundle's ``xla_cache/`` (its persistent compile cache) has no
counterpart: a capture compiles nothing, so there is nothing to cache
across processes, and flight ``compile`` events carry
``persistent_cache=""``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

from ..device import DeviceLike, resolve_device
from ..observability import flight as _flight
from ..observability import hbm as _hbm
from ..observability import metrics as _metrics
from ..observability.logging import get_logger

logger = get_logger("mmlspark_tpu_torch.bundles")

FORMAT_VERSION = 1
MANIFEST_NAME = "MANIFEST.json"
PROGRAMS_DIR = "programs"


class BundleError(Exception):
    """A bundle that cannot be used (missing, torn, or mismatched).

    Raised by the offline/strict paths; the serving prewarm path catches
    it and degrades to online capture with the structured warning
    instead — a bad bundle must never keep a worker from coming up."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def model_hash(model_path: str) -> str:
    """Content hash of a model artifact: file bytes for a ``.txt``/``.npz``
    booster, a stable digest over (relpath, file-sha) pairs for a saved
    pipeline directory. The bundle pins it so a bundle built from one
    model never prewarms another."""
    if os.path.isdir(model_path):
        h = hashlib.sha256()
        for root, dirs, files in os.walk(model_path):
            dirs.sort()
            for name in sorted(files):
                p = os.path.join(root, name)
                rel = os.path.relpath(p, model_path).replace(os.sep, "/")
                h.update(rel.encode("utf-8"))
                h.update(_sha256_file(p).encode("ascii"))
        return h.hexdigest()
    return _sha256_file(model_path)


def runtime_fingerprint(device: DeviceLike = None,
                        model_sha256: Optional[str] = None
                        ) -> Dict[str, Any]:
    """What must match between bundle build and prewarm for the bundle's
    plans to be trusted: the package and torch versions, the CUDA runtime,
    the device name and compute capability (``cpu`` and None off the
    card) and the model's hash."""
    import torch

    from .. import __version__

    dev = resolve_device(device)
    if dev.type == "cuda":
        name = torch.cuda.get_device_name(dev)
        cc = "%d.%d" % torch.cuda.get_device_capability(dev)
    else:
        name, cc = "cpu", None
    return {"framework_version": __version__,
            "torch_version": torch.__version__,
            "cuda_runtime": torch.version.cuda,
            "device_name": name, "compute_capability": cc,
            "model_sha256": model_sha256}


def _fingerprint_mismatches(built: Dict[str, Any],
                            now: Dict[str, Any]) -> List[str]:
    return [f"{k}: built={built.get(k)!r} runtime={now.get(k)!r}"
            for k in sorted(set(built) | set(now))
            if built.get(k) != now.get(k)]


def boosters_of(model: Any) -> List[Any]:
    """Every :class:`Booster` an in-memory model predicts through, in a
    stable order: the booster itself, or the ``.booster`` of each fitted
    GBDT stage of a pipeline. The bundle indexes entries by position in
    this list."""
    from ..models.gbdt.booster import Booster

    if isinstance(model, Booster):
        return [model]
    out = []
    stages = getattr(model, "stages", None) or [model]
    for stage in stages:
        b = getattr(stage, "booster", None)
        if isinstance(b, Booster):
            out.append(b)
    return out


def load_model_boosters(model_path: str) -> List[Any]:
    """:func:`boosters_of` for a model on disk: a ``.txt`` or ``.npz``
    booster, or the fitted GBDT stages of a saved pipeline directory."""
    from ..models.gbdt.booster import Booster

    if model_path.endswith(".txt"):
        with open(model_path) as f:
            return [Booster.from_string(f.read())]
    if model_path.endswith(".npz"):
        # native persistence keeps the binner grid the int8 lane needs
        return [Booster.load(model_path)]
    from ..core.pipeline import load_stage
    return boosters_of(load_stage(model_path))


def _default_batch_sizes(max_batch: int) -> List[int]:
    """The ladder serving dispatches: the pow2 grid up to the batch cap,
    unioned with the tuner's measured rungs when a tuning store is wired
    (``bundles build --tuned-from <store>``)."""
    from .. import tuning as _tuning

    sizes, b = [], 1
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch)
    ladder = _tuning.resolve_bucket_ladder() or ()
    sizes.extend(r for r in ladder if r <= max_batch)
    return sorted(set(sizes))


def _plan_json(plan) -> bytes:
    return json.dumps({"key": repr(plan.key), "n_pad": plan.n_pad,
                       "t_pad": plan.T_pad,
                       "num_features": plan.num_features,
                       "predict_dtype": plan.predict_dtype},
                      sort_keys=True).encode("utf-8")


def build_bundle(model_path: str, out_dir: str,
                 batch_sizes: Optional[List[int]] = None,
                 max_batch: int = 32,
                 num_iterations: Tuple[int, ...] = (-1,),
                 include_raw: bool = False,
                 predict_dtypes: Tuple[str, ...] = ("f32",),
                 force: bool = False,
                 device: DeviceLike = None) -> Dict[str, Any]:
    """Write the plans of every predict program a serving deployment of
    ``model_path`` on ``device`` (default ``cuda``; the fingerprint names
    its card) will dispatch to, as an atomic, versioned, checksummed
    bundle directory. Returns the manifest.

    ``predict_dtypes`` adds quantized lanes (``"bf16"``/``"int8"``); lanes
    the model degrades dedupe into their f32 plans. The bundle is written
    to a sibling temp directory and renamed into place, so a crashed build
    never leaves a half-written bundle where a prewarm could find it."""
    from ..models.gbdt.booster import iter_predict_plans, predict_key_hash

    t0 = time.perf_counter()
    boosters = load_model_boosters(model_path)
    if not boosters:
        raise BundleError(f"no boosters found in model {model_path!r} — "
                          "nothing to bundle")
    if batch_sizes is None:
        batch_sizes = _default_batch_sizes(max_batch)
    out_dir = os.path.abspath(out_dir)
    if os.path.exists(out_dir) and not force:
        raise BundleError(f"bundle dir {out_dir} already exists "
                          "(pass force=True / --force to replace)")
    tmp = f"{out_dir}.tmp-{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(os.path.join(tmp, PROGRAMS_DIR))
    mh = model_hash(model_path)

    entries: List[Dict[str, Any]] = []
    transforms = (True, False) if include_raw else (True,)
    seen_keys = set()
    for bi, booster in enumerate(boosters):
        # keys are model-independent (the forest rides beside the
        # program), so two same-shape stages share one entry
        for meta, plan in iter_predict_plans(booster, batch_sizes,
                                             num_iterations, transforms,
                                             dtypes=tuple(predict_dtypes)):
            if plan.key in seen_keys:
                continue
            seen_keys.add(plan.key)
            key_hash = predict_key_hash(plan.key)
            blob = _plan_json(plan)
            fname = f"{key_hash}.json"
            with open(os.path.join(tmp, PROGRAMS_DIR, fname), "wb") as f:
                f.write(blob)
            entries.append({**meta, "booster_index": bi,
                            "n_pad": plan.n_pad, "t_pad": plan.T_pad,
                            "key_hash": key_hash,
                            "file": f"{PROGRAMS_DIR}/{fname}",
                            "sha256": hashlib.sha256(blob).hexdigest(),
                            "size_bytes": len(blob)})
    manifest = {
        "format_version": FORMAT_VERSION,
        "created_at": time.time(),
        "model": {"path": os.path.abspath(model_path), "sha256": mh,
                  "boosters": len(boosters)},
        "fingerprint": runtime_fingerprint(device, mh),
        "entries": entries,
    }
    from .. import tuning as _tuning
    if _tuning.enabled():
        manifest["tuning"] = _tuning.provenance()
    with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
    if os.path.exists(out_dir):          # force=True
        shutil.rmtree(out_dir)
    os.rename(tmp, out_dir)
    dt = time.perf_counter() - t0
    _metrics.safe_histogram("bundle_build_seconds").observe(dt)
    _flight.record("bundle", event="built", path=out_dir,
                   entries=len(entries), seconds=round(dt, 3))
    logger.info("bundle built", path=out_dir, entries=len(entries),
                seconds=round(dt, 3))
    return manifest


def read_manifest(bundle_dir: str) -> Dict[str, Any]:
    """Parse and structurally validate a bundle's manifest. Raises
    :class:`BundleError` on anything torn."""
    path = os.path.join(bundle_dir, MANIFEST_NAME)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise BundleError(f"unreadable bundle manifest {path}: "
                          f"{type(e).__name__}: {e}") from e
    if not isinstance(manifest, dict) or "entries" not in manifest \
            or "fingerprint" not in manifest:
        raise BundleError(f"malformed bundle manifest {path}")
    if manifest.get("format_version") != FORMAT_VERSION:
        raise BundleError(
            f"bundle format_version {manifest.get('format_version')!r} "
            f"(this build reads {FORMAT_VERSION})")
    return manifest


def _count_load(status: str) -> None:
    _metrics.safe_counter("bundle_loads_total", status=status).inc()


def _warn_fallback(bundle_dir: str, status: str, **fields) -> None:
    """THE loud structured degradation: one warning record, one flight
    event and the status-labeled counter; the caller then captures online
    on first use. Wrong numerics are impossible by construction (programs
    install only under keys recomputed from the live model)."""
    logger.warning("serving bundle unusable, capturing online instead: "
                   "%s", status, bundle=bundle_dir, status=status,
                   **fields)
    _flight.record("bundle", event=status, bundle=bundle_dir, **fields)
    _count_load(status)


def prewarm(model_path: str, bundle_dir: str,
            boosters: Optional[List[Any]] = None,
            device: DeviceLike = None) -> Dict[str, Any]:
    """Fill the predictor cache on ``device`` (default ``cuda``) from a
    bundle before a worker binds: each entry's graph is captured against
    the live model and installed.

    Returns ``{status, entries_loaded, entries_skipped, seconds}``.
    Degrades (never raises) on any defect: a missing or torn bundle,
    version or fingerprint skew, a checksum mismatch, a bad entry — each
    a structured warning and ``bundle_*`` telemetry, the affected programs
    then captured online. Only a failed capture raises (as it does
    online). ``boosters`` passes the already-loaded model (the serving
    worker has it); keys are recomputed from it."""
    t0 = time.perf_counter()
    stats = {"status": "ok", "entries_loaded": 0, "entries_skipped": 0}
    _flight.record("bundle", event="prewarm_begin", bundle=bundle_dir)
    try:
        manifest = read_manifest(bundle_dir)
    except BundleError as e:
        _warn_fallback(bundle_dir, "corrupt", error=str(e))
        stats["status"] = "corrupt"
        return _finish(stats, t0)

    mh = (model_hash(model_path) if os.path.exists(model_path)
          else manifest.get("model", {}).get("sha256"))
    mismatches = _fingerprint_mismatches(manifest["fingerprint"],
                                         runtime_fingerprint(device, mh))
    if mismatches:
        _warn_fallback(bundle_dir, "fingerprint_mismatch",
                       mismatches=mismatches)
        stats["status"] = "fingerprint_mismatch"
        return _finish(stats, t0)

    if boosters is None:
        boosters = load_model_boosters(model_path)
    dev = resolve_device(device)
    loaded = skipped = 0
    for entry in manifest["entries"]:
        if _load_entry(bundle_dir, entry, boosters, dev):
            loaded += 1
        else:
            skipped += 1
    stats.update(entries_loaded=loaded, entries_skipped=skipped)
    if loaded == 0 and manifest["entries"]:
        stats["status"] = "empty"
        _warn_fallback(bundle_dir, "empty",
                       entries=len(manifest["entries"]))
    else:
        _count_load("ok")
    return _finish(stats, t0)


def _finish(stats: Dict[str, Any], t0: float) -> Dict[str, Any]:
    stats["seconds"] = round(time.perf_counter() - t0, 3)
    _metrics.safe_histogram("bundle_prewarm_seconds").observe(
        stats["seconds"])
    _flight.record("bundle", event="prewarm_complete", **stats)
    logger.info("bundle prewarm complete", **stats)
    return stats


def _load_entry(bundle_dir: str, entry: Dict[str, Any],
                boosters: List[Any], dev) -> bool:
    """Verify one manifest entry, capture its program against the live
    model and install it in the predictor cache. False (with telemetry)
    on any defect — that bucket is captured online instead, nothing
    else."""
    from ..models.gbdt.booster import (_ObservedProgram, predict_key_hash,
                                       preload_predict_program)

    def skip(reason: str, **fields) -> bool:
        _metrics.safe_counter("bundle_entries_skipped_total",
                              reason=reason).inc()
        _flight.record("bundle", event="entry_skipped", reason=reason,
                       key_hash=entry.get("key_hash", ""), **fields)
        logger.warning("bundle entry skipped: %s", reason,
                       key_hash=entry.get("key_hash", ""), **fields)
        return False

    try:
        bi = int(entry.get("booster_index", 0))
        batch_size = int(entry["batch_size"])
        num_iteration = int(entry["num_iteration"])
        transformed = bool(entry["transformed"])
        predict_dtype = str(entry.get("predict_dtype", "f32"))
        entry["file"], entry["sha256"]
    except (KeyError, TypeError, ValueError) as e:
        return skip("malformed_entry", error=f"{type(e).__name__}: {e}")
    if not 0 <= bi < len(boosters):
        return skip("booster_index_out_of_range", booster_index=bi)
    booster = boosters[bi]
    try:
        plan = booster.predict_plan(batch_size, num_iteration,
                                    transformed=transformed,
                                    predict_dtype=predict_dtype)
    except ValueError as e:
        return skip("malformed_entry", error=f"{type(e).__name__}: {e}")
    key_hash = predict_key_hash(plan.key)
    if key_hash != entry.get("key_hash"):
        _metrics.safe_counter("bundle_key_miss_total").inc()
        return skip("key_mismatch", expected=entry.get("key_hash", ""),
                    computed=key_hash)
    root = os.path.abspath(bundle_dir)
    path = os.path.normpath(
        os.path.join(root, *entry["file"].split("/")))
    if not path.startswith(root + os.sep):
        return skip("path_escape", file=entry["file"])
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        return skip("missing_program", error=f"{type(e).__name__}: {e}")
    if hashlib.sha256(blob).hexdigest() != entry.get("sha256"):
        return skip("checksum_mismatch", file=entry["file"])
    try:
        stored = json.loads(blob.decode("utf-8"))["key"]
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        return skip("malformed_program", error=f"{type(e).__name__}: {e}")
    if stored != repr(plan.key):
        return skip("key_mismatch", expected=stored, computed=repr(plan.key))
    prog = _ObservedProgram(plan.make_program(dev), plan.key,
                            dtype=plan.predict_dtype)
    forest, active = booster.predict_plan_args(plan, dev)
    # a capture that fails raises: the worker does not come up half-warm
    seconds = prog.prepare(forest, active, plan.t_end, observed=False)
    if not preload_predict_program(plan.key, prog, dtype=plan.predict_dtype,
                                   device=dev):
        return skip("already_cached")
    _hbm.claim("bundle_prewarm", float(prog.program.pinned_bytes))
    _metrics.safe_counter("bundle_entries_loaded_total").inc()
    _flight.record("bundle", event="entry_loaded", key_hash=key_hash,
                   batch_size=batch_size, n_pad=plan.n_pad,
                   t_pad=plan.T_pad, predict_dtype=plan.predict_dtype,
                   capture_seconds=round(seconds, 6),
                   graph=prog.program.captured)
    return True
