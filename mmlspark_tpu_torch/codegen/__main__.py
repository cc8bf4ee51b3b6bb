"""CLI: ``python -m mmlspark_tpu_torch.codegen [output_dir]`` — emit the
generated ``mmlspark`` compat namespace over the port, its API reference,
migration table, R wrappers and smoke tests (the build-time codegen step;
reference: sbt packagePythonTask at build.sbt:204-247). The default
``output_dir`` is ``build/python_api_torch`` under the current directory."""

import sys

from ..observability.logging import console
from . import generate_all

DEFAULT_OUTPUT = "build/python_api_torch"

if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUTPUT
    result = generate_all(out)
    console(f"wrote {len(result['namespace_files'])} namespace modules, "
            f"{result['docs']}, {result['tests']}, "
            f"{result['migration']}")
