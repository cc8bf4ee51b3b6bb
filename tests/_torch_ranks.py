"""Run a snippet of the PyTorch port in several processes joined by gloo.

``run_ranks(tmp_path, world, body)`` starts ``world`` Python processes on
the CPU; each joins one ``torch.distributed`` group through a ``file://``
rendezvous under ``tmp_path`` (no TCP port, so parallel test workers
cannot collide), runs ``body`` with ``rank`` and ``world`` bound, and
writes the JSON value of its ``result`` variable. Returns the results in
rank order. The processes import the port only (no JAX), with one torch
thread each.
"""

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRELUDE = """
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from mmlspark_tpu_torch.parallel import distributed
rank, world = int(sys.argv[1]), int(sys.argv[2])
if world > 1:
    distributed.initialize(sys.argv[3], world, rank, device="cpu")
result = None
"""

_EPILOGUE = """
with open(sys.argv[4], "w") as f:
    json.dump(result, f)
if world > 1:
    torch.distributed.destroy_process_group()
"""


def run_ranks(tmp_path, world: int, body: str, timeout: float = 120.0,
              env=None) -> list:
    """The ``result`` of ``body`` on each of ``world`` ranks, in rank
    order. Raises with a rank's stderr if it fails."""
    tag = f"w{world}_{len(os.listdir(tmp_path))}"
    src = _PRELUDE + textwrap.dedent(body) + _EPILOGUE
    init = f"file://{tmp_path}/rdv_{tag}"
    penv = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                **(env or {}))
    procs, outs = [], []
    for r in range(world):
        out = os.path.join(str(tmp_path), f"out_{tag}_{r}.json")
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", src, str(r), str(world), init, out],
            env=penv, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    errs = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errs.append(f"rank {r} rc {p.returncode}:\n{err[-3000:]}")
    if errs:
        raise AssertionError("\n".join(errs))
    results = []
    for out in outs:
        with open(out) as f:
            results.append(json.load(f))
    return results
