"""Step-level training checkpoints: save and resume mid-train.

The port's copy of ``mmlspark_tpu/utils/checkpoint.py`` (reference:
lightgbm/LightGBMBase.scala:28-50 numBatches; TrainUtils.scala:165-168
warm start through LGBM_BoosterMerge). ``train_booster`` checkpoints every
N boosting iterations and a rerun with the same data and config resumes
where the last checkpoint left off.

``CheckpointManager`` keeps atomic pickle files named by step, the newest
``keep`` of them, with no threads: host state only (model strings, score
matrices as numpy), never live device tensors. The JAX copy's fault
injection hook is left out.

Over a data group of several ranks, :class:`GroupCheckpoints` gives the
directory one writer and one reader, rank 0: the payloads are the
topology-free ones of one process (the whole score matrices, gathered),
so a checkpoint written on R ranks resumes on R'.

A checkpoint's fingerprint hashes the run's config, which holds the
package's own ``GrowConfig``; the two packages' configs differ, so a
checkpoint written by one package is not resumed by the other.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import re
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


class CheckpointMismatchError(RuntimeError):
    """Strict-resume refusal: checkpoints exist in the directory but none
    matches the run's data/config fingerprint."""


def data_fingerprint(*arrays, config: Any = None) -> str:
    """Content hash of the training inputs and the config.

    Stored in every checkpoint and compared on resume, so a checkpoint of
    other data or other hyperparameters is never resumed. Small arrays are
    hashed in full; large ones combine 64 strided 4 KiB pages (sha256) with
    a crc32 of the whole buffer, which catches a changed byte anywhere."""
    h = hashlib.sha256()
    page, max_pages = 4096, 64
    for a in arrays:
        if a is None:
            h.update(b"<none>")
            continue
        a = np.ascontiguousarray(a)
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        raw = a.reshape(-1).view(np.uint8)
        nbytes = raw.size
        if nbytes <= page * max_pages:
            h.update(raw.tobytes())
        else:
            starts = np.linspace(0, nbytes - page, max_pages).astype(np.int64)
            for s in starts:
                h.update(raw[s:s + page].tobytes())
            h.update(zlib.crc32(raw).to_bytes(4, "little"))
    if config is not None:
        h.update(repr(config).encode())
    return h.hexdigest()[:32]


class CheckpointManager:
    """Atomic step-indexed checkpoints in a directory, newest ``keep`` kept.

    ``namespace`` (the run's fingerprint prefix) isolates runs that share
    one directory, such as the trials of a sweep, so one run's pruning
    never deletes another run's files. Without it the manager sees every
    checkpoint file in the directory."""

    def __init__(self, directory: str, keep: int = 3,
                 namespace: Optional[str] = None):
        self.directory = directory
        self.keep = max(1, int(keep))
        self.namespace = namespace
        self._re = (re.compile(rf"^ckpt_{re.escape(namespace)}_(\d+)\.pkl$")
                    if namespace else
                    re.compile(r"^ckpt_(?:[0-9a-f]+_)?(\d+)\.pkl$"))
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        ns = f"{self.namespace}_" if self.namespace else ""
        return os.path.join(self.directory, f"ckpt_{ns}{step:010d}.pkl")

    def _files(self) -> List[Tuple[int, str]]:
        out = []
        for name in os.listdir(self.directory):
            m = self._re.match(name)
            if m:
                out.append((int(m.group(1)), name))
        return sorted(out)

    def steps(self) -> List[int]:
        return sorted({s for s, _ in self._files()})

    def save(self, step: int, payload: Dict[str, Any]) -> str:
        """Write ``payload`` for ``step`` to a temporary file, publish it
        with one atomic rename, then prune to the newest ``keep``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"step": step, **payload}, f)
        os.replace(tmp, path)
        self._prune()
        return path

    def load(self, step: int) -> Dict[str, Any]:
        path = self._path(step)
        if not os.path.exists(path) and self.namespace is None:
            for s, name in self._files():
                if s == step:
                    path = os.path.join(self.directory, name)
                    break
        with open(path, "rb") as f:
            return pickle.load(f)

    def latest(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        steps = self.steps()
        if not steps:
            return None
        return steps[-1], self.load(steps[-1])

    def _prune(self) -> None:
        for _, name in self._files()[:-self.keep]:
            try:
                os.remove(os.path.join(self.directory, name))
            except OSError:
                pass

    def latest_matching(self, fingerprint: str, purge_stale: bool = True,
                        strict: bool = False
                        ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """Newest checkpoint whose stored fingerprint matches.

        Mismatching files this manager sees are removed when
        ``purge_stale``, so a stale file with a higher step cannot shadow
        the new run's checkpoints. ``strict``: when checkpoints exist but
        none matches, raise :class:`CheckpointMismatchError` instead of
        returning None (and purge nothing)."""
        best = None
        found: List[str] = []
        for step, name in self._files():
            path = os.path.join(self.directory, name)
            try:
                with open(path, "rb") as f:
                    payload = pickle.load(f)
            except Exception:
                continue
            if payload.get("fingerprint") == fingerprint:
                best = (step, payload)
            else:
                found.append(str(payload.get("fingerprint")))
                if purge_stale and not strict:
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        if strict and best is None and found:
            raise CheckpointMismatchError(
                f"no checkpoint in {self.directory!r} matches fingerprint "
                f"{fingerprint!r} (found {sorted(set(found))}): the data, "
                "config or warm-start model changed since the interrupted "
                "run")
        return best


class GroupCheckpoints:
    """One writer and one reader of a checkpoint directory for a data
    group (``mesh``: a :class:`...parallel.mesh.Mesh`).

    Rank 0 of the group alone owns the :class:`CheckpointManager`: it
    reads, purges stale files, writes and prunes, so no two ranks race on
    one file. The other ranks never touch ``directory`` (they need no
    shared file system): :meth:`latest` hands them what rank 0 read, and
    rank 0's failure (a :class:`CheckpointMismatchError` under strict
    resume, an unreadable directory) is raised on every rank. Before any
    file is read the ranks compare their data fingerprints: ranks fed
    other rows raise ``ValueError`` together instead of resuming each
    other's state. On one process this is the manager itself."""

    def __init__(self, directory: str, fingerprint: str, mesh):
        mesh.check_same(fingerprint[:32], "the checkpoint data fingerprint")
        self.directory, self.fingerprint, self.mesh = (directory,
                                                       fingerprint, mesh)
        self.writer = mesh.rank == 0
        self.manager = (CheckpointManager(directory,
                                          namespace=fingerprint[:12])
                        if self.writer else None)

    def latest(self, strict_probe: bool = False
               ) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The newest checkpoint matching the fingerprint, on every rank
        (None where there is none). ``strict_probe``: when the run's
        namespace holds none, look across every namespace in strict mode
        (a mismatch raises :class:`CheckpointMismatchError`; a match is a
        legacy un-namespaced checkpoint)."""
        def read():
            found = self.manager.latest_matching(self.fingerprint)
            if found is None and strict_probe:
                found = CheckpointManager(self.directory).latest_matching(
                    self.fingerprint, purge_stale=False, strict=True)
            return found
        return self.mesh.from_first(read)

    def save(self, step: int, payload: Dict[str, Any]) -> Optional[str]:
        """Rank 0 writes ``payload`` for ``step``; elsewhere a no-op. Any
        collective the payload needs runs before, on every rank."""
        return self.manager.save(step, payload) if self.writer else None
