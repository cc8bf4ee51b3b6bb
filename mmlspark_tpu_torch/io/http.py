"""HTTP helpers of the port: for now only :func:`to_jsonable`.

Counterpart of ``to_jsonable`` in ``mmlspark_tpu/io/http.py``; the rest
of that module (``HTTPTransformer``, the connection pool, the request and
response schema) is not ported yet.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def to_jsonable(v: Any) -> Any:
    """numpy scalars/arrays, bytes, containers -> JSON-able python values.
    Shared by the serving replies of both engines."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, dict):
        return {k: to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [to_jsonable(x) for x in v]
    return v
