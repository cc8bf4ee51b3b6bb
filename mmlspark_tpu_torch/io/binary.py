"""Binary file ingestion: directories (and zips) -> (path, bytes) Datasets.

The port's copy of ``mmlspark_tpu/io/binary.py`` (host code, unchanged).
Parity: io/binary/BinaryFileFormat.scala:34-245 (Hadoop file format with
subsampling + zip inspection), BinaryFileReader.scala:20. The Hadoop input
format becomes a host-side walk: recursive glob, optional seeded subsampling,
and transparent descent into ``.zip`` members (the reference inspects zips so
image corpora can ship zipped).
"""

from __future__ import annotations

import fnmatch
import os
import zipfile
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..core.dataset import Dataset


def _iter_files(path: str, recursive: bool) -> Iterator[str]:
    if os.path.isfile(path):
        yield path
        return
    if recursive:
        for root, _, files in os.walk(path):
            for f in sorted(files):
                yield os.path.join(root, f)
    else:
        for f in sorted(os.listdir(path)):
            full = os.path.join(path, f)
            if os.path.isfile(full):
                yield full


def read_binary_files(path: str, recursive: bool = True,
                      sample_ratio: float = 1.0, seed: int = 0,
                      glob: Optional[str] = None,
                      inspect_zip: bool = True) -> Dataset:
    """Read files under ``path`` into a Dataset with ``path`` and ``bytes``
    columns. Zip archives contribute one row per member as
    ``archive.zip!member`` (BinaryFileFormat's zip inspection)."""
    rng = np.random.default_rng(seed)
    paths: List[str] = []
    blobs: List[bytes] = []

    def keep() -> bool:
        return sample_ratio >= 1.0 or rng.random() < sample_ratio

    for f in _iter_files(path, recursive):
        name = os.path.basename(f)
        if inspect_zip and zipfile.is_zipfile(f):
            with zipfile.ZipFile(f) as zf:
                for member in zf.namelist():
                    if member.endswith("/"):
                        continue
                    if glob and not fnmatch.fnmatch(member, glob):
                        continue
                    if keep():
                        paths.append(f"{f}!{member}")
                        blobs.append(zf.read(member))
        else:
            if glob and not fnmatch.fnmatch(name, glob):
                continue
            if keep():
                paths.append(f)
                with open(f, "rb") as fh:
                    blobs.append(fh.read())
    return Dataset({"path": paths, "bytes": blobs})


def read_binary_file(path: str) -> Tuple[str, bytes]:
    """Single file (possibly a ``zip!member`` path) -> (path, bytes)."""
    if "!" in path and not os.path.exists(path):
        archive, member = path.split("!", 1)
        with zipfile.ZipFile(archive) as zf:
            return path, zf.read(member)
    with open(path, "rb") as fh:
        return path, fh.read()
