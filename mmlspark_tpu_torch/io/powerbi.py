"""PowerBI writer: batch + streaming POST of Datasets to a REST endpoint.

The port's copy of ``mmlspark_tpu/io/powerbi.py``. Parity:
io/powerbi/PowerBIWriter.scala:17-27 — rows are serialized to the PowerBI
JSON payload shape (``{"rows": [...]}``-style array body) and POSTed in
batches with the shared retry/backoff handler.
"""

from __future__ import annotations

import json
from typing import Optional

from ..core.dataset import Dataset
from .http import (AsyncHTTPClient, HTTPRequestData, SingleThreadedHTTPClient,
                   advanced_handling, to_jsonable)


def write_to_powerbi(dataset: Dataset, url: str, batch_size: int = 1000,
                     concurrency: int = 1,
                     timeout: float = 60.0) -> int:
    """POST the dataset to a PowerBI push-dataset URL in row batches, up to
    ``concurrency`` batches in flight. Returns the number of batches written;
    raises if any batch ends non-2xx after retries (fail-fast semantics)."""
    requests = []
    for batch in dataset.batches(batch_size):
        body = json.dumps(
            [to_jsonable(r) for r in batch.to_rows()]).encode("utf-8")
        requests.append(HTTPRequestData(
            url=url, method="POST",
            headers={"Content-Type": "application/json"}, entity=body))
    handler = lambda r: advanced_handling(r, timeout=timeout)  # noqa: E731
    client = (AsyncHTTPClient(concurrency, handler=handler)
              if concurrency > 1 else SingleThreadedHTTPClient(handler))
    for resp in client.send(requests):
        if not (200 <= resp.status_code < 300):
            raise IOError(
                f"PowerBI write failed: {resp.status_code} {resp.reason}")
    return len(requests)


class PowerBIWriter:
    """Streaming analog: accumulate rows, flush every ``batch_size``."""

    def __init__(self, url: str, batch_size: int = 1000, timeout: float = 60.0):
        self.url = url
        self.batch_size = batch_size
        self.timeout = timeout
        self._buffer = []

    def write(self, dataset: Dataset) -> None:
        self._buffer.extend(dataset.to_rows())
        while len(self._buffer) >= self.batch_size:
            chunk, self._buffer = (self._buffer[:self.batch_size],
                                   self._buffer[self.batch_size:])
            write_to_powerbi(Dataset.from_rows(chunk), self.url,
                             batch_size=self.batch_size, timeout=self.timeout)

    def flush(self) -> None:
        if self._buffer:
            write_to_powerbi(Dataset.from_rows(self._buffer), self.url,
                             batch_size=self.batch_size, timeout=self.timeout)
            self._buffer = []


