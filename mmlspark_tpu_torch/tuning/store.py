"""Tuning store: versioned, fingerprinted persistence of measured
evidence and resolved decisions.

The measure→decide loop (``mmlspark_tpu_torch/tuning``) is only worth its
calibration cost if the SECOND process starts tuned: decisions
serialize here as one JSON document per store directory
(``MMLSPARK_TPU_TUNING_DIR``), written atomically (tmp + rename, the
bundle-build idiom) so a crashed writer can never leave a torn store
where a restarting worker would read it.

The store is fingerprinted like the bundle manifest — device kind,
model content hash, framework version — because every decision in it
is a *measurement* of those three things: an engine winner measured on
one device kind says nothing about another, and a bucket ladder derived
from one model's serving workload must not shape another model's
compiled-program keys. A mismatched fingerprint degrades LOUDLY to the
static rules (structured warning + flight event + counter), never to a
silently mis-tuned process. ``None`` fingerprint fields are wildcards:
a store written before the process learned its device kind still loads
on the process that can.

Serialization is deterministic on purpose (sorted keys, no
timestamps): the replay-determinism contract — same ledger bytes, same
decisions — is pinned by byte-comparing stores in tests.

Only this package may read or write the store file (graftlint
``tuning-store-funnel``): an ad-hoc reader would bypass the version and
fingerprint checks that make a stale store safe.

Stdlib-only: a gateway rendering ``/debug/tuning`` must never drag jax
in (the roofline rule).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

TUNING_DIR_ENV = "MMLSPARK_TPU_TUNING_DIR"
STORE_NAME = "tuning.json"
FORMAT_VERSION = 1

__all__ = ["TUNING_DIR_ENV", "STORE_NAME", "FORMAT_VERSION", "StoreError",
           "store_path", "load_store", "save_store", "store_fingerprint",
           "fingerprint_mismatches"]


class StoreError(Exception):
    """A tuning store that cannot be used (missing, torn, or from a
    different format). Callers catch it and degrade to static rules."""


def store_path(directory: str) -> str:
    return os.path.join(os.path.abspath(directory), STORE_NAME)


def store_fingerprint(device_kind: Optional[str] = None,
                      model_sha256: Optional[str] = None) -> Dict[str, Any]:
    """What must match between the process that measured and the process
    that reuses the measurement. ``None`` = not known yet (wildcard)."""
    from .. import __version__

    return {"framework_version": __version__,
            "device_kind": device_kind,
            "model_sha256": model_sha256}


def fingerprint_mismatches(built: Dict[str, Any],
                           now: Dict[str, Any]) -> List[str]:
    """Concrete-vs-concrete disagreements (``None`` on either side is
    "unknown" and matches anything — a store written before the writer
    learned its device kind must still load where it applies)."""
    out = []
    for k in sorted(set(built) | set(now)):
        b, n = built.get(k), now.get(k)
        if b is not None and n is not None and b != n:
            out.append(f"{k}: stored={b!r} runtime={n!r}")
    return out


def load_store(directory: str) -> Dict[str, Any]:
    """Parse + structurally validate the store. Raises :class:`StoreError`
    on anything unreadable; a missing file returns an empty skeleton (a
    fresh store directory is the normal first-process state, not an
    error)."""
    path = store_path(directory)
    if not os.path.exists(path):
        return {"format_version": FORMAT_VERSION, "fingerprint": {},
                "evidence": {}, "decisions": {}}
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, ValueError) as e:
        raise StoreError(f"unreadable tuning store {path}: "
                         f"{type(e).__name__}: {e}") from e
    if not isinstance(payload, dict) or "decisions" not in payload \
            or "fingerprint" not in payload:
        raise StoreError(f"malformed tuning store {path}")
    if payload.get("format_version") != FORMAT_VERSION:
        raise StoreError(
            f"tuning store format_version "
            f"{payload.get('format_version')!r} "
            f"(this build reads {FORMAT_VERSION})")
    payload.setdefault("evidence", {})
    return payload


def save_store(directory: str, payload: Dict[str, Any]) -> str:
    """Atomic write (tmp + rename): a reader sees the old store or the
    new one, never a torn file. Deterministic bytes: sorted keys, no
    wall-clock fields — the replay contract is byte-comparable."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = store_path(directory)
    tmp = f"{path}.tmp-{os.getpid()}"
    body = json.dumps(payload, indent=2, sort_keys=True)
    with open(tmp, "w") as f:
        f.write(body + "\n")
    os.replace(tmp, path)
    return path
