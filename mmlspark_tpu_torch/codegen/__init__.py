"""Codegen: the reflection-driven language-binding layer, over the port.

Counterpart of ``mmlspark_tpu/codegen``. The reference autogenerates its
PySpark + R API surface at build time by walking every ``Wrappable`` stage
(reference: src/test/scala/com/microsoft/ml/spark/codegen/CodeGen.scala:
13-68, WrapperGenerator.scala:21-80, PySparkWrapper.scala:22-346). This
module walks the port's stages (:func:`..core.fuzzing.discover_stages`)
and produces, for ``mmlspark_tpu_torch``:

- a **PySpark-compatible ``mmlspark`` namespace**: generated modules mapping
  the reference's package layout (``mmlspark.lightgbm``, ``mmlspark.vw``,
  ``mmlspark.cognitive``, ...) onto the port's classes, each fitted with
  camelCase ``setX``/``getX`` accessors reflected from its Params (the
  port's estimators carry a ``device`` Param, so ``setDevice`` too);
- an **API reference document** and a **migration table** listing every
  stage and param;
- **SparklyR-style R wrappers** dispatching through reticulate;
- **generated smoke tests** (default-construct + param round-trip per
  stage), the PySparkWrapperTest.scala analog.

Run ``python -m mmlspark_tpu_torch.codegen [output_dir]`` to emit
everything; the default directory is ``build/python_api_torch`` (the
JAX package's generator owns ``python_api/``). Both generators emit a
package named ``mmlspark``: put one of the two trees on ``sys.path``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Type

from ..core.fuzzing import discover_stages
from ..core.pipeline import PipelineStage

# reference package layout (mmlspark.<pkg>) -> our module prefixes
NAMESPACE_MAP = [
    ("lightgbm", "mmlspark_tpu_torch.models.gbdt"),
    ("vw", "mmlspark_tpu_torch.models.vw"),
    ("cntk", "mmlspark_tpu_torch.models.dnn.scoring"),
    ("image", "mmlspark_tpu_torch.image"),
    ("cognitive", "mmlspark_tpu_torch.cognitive"),
    ("stages", "mmlspark_tpu_torch.stages"),
    ("featurize", "mmlspark_tpu_torch.featurize"),
    ("io.http", "mmlspark_tpu_torch.io.http"),
    ("io", "mmlspark_tpu_torch.io"),
    ("nn", "mmlspark_tpu_torch.nn"),
    ("recommendation", "mmlspark_tpu_torch.recommendation"),
    ("automl", "mmlspark_tpu_torch.automl"),
    ("train", "mmlspark_tpu_torch.train"),
    ("lime", "mmlspark_tpu_torch.explain"),
    ("cyber", "mmlspark_tpu_torch.cyber"),
    ("isolationforest", "mmlspark_tpu_torch.models.isolation_forest"),
    ("core", "mmlspark_tpu_torch.core"),
]

# classes the reference knows under a different name
ALIASES = {
    "DNNModel": ["CNTKModel"],
}


def attach_pyspark_accessors(cls: Type[PipelineStage]) -> Type[PipelineStage]:
    """Add PySpark-style ``setFoo``/``getFoo`` per Param, reflected exactly
    like the reference's generated wrappers (PySparkWrapper.scala:22-346)."""
    for param in cls.params():
        cap = param.name[0].upper() + param.name[1:]
        if not hasattr(cls, f"set{cap}"):
            def setter(self, value, _name=param.name):
                self.set(**{_name: value})
                return self
            setter.__name__ = f"set{cap}"
            setter.__doc__ = f"Set {param.name}: {param.doc}"
            setattr(cls, f"set{cap}", setter)
        if not hasattr(cls, f"get{cap}"):
            def getter(self, _name=param.name):
                return self.get_or_default(_name)
            getter.__name__ = f"get{cap}"
            getter.__doc__ = f"Get {param.name}: {param.doc}"
            setattr(cls, f"get{cap}", getter)
    return cls


def _group_stages() -> Dict[str, List[str]]:
    """namespace -> sorted list of qualified stage names."""
    groups: Dict[str, List[str]] = {}
    for qualname in sorted(discover_stages()):
        module = qualname.rsplit(".", 1)[0]
        for ns, prefix in NAMESPACE_MAP:
            if module.startswith(prefix):
                groups.setdefault(ns, []).append(qualname)
                break
    return groups


_MODULE_TEMPLATE = '''"""Generated by mmlspark_tpu_torch.codegen — do not edit.

PySpark-compatible surface for the reference's ``mmlspark.{ns}`` package
(reference: codegen/PySparkWrapper.scala generated wrappers).
"""

from mmlspark_tpu_torch.codegen import attach_pyspark_accessors as _attach

{imports}

{attach}
__all__ = [{all_names}]
'''


def generate_compat_namespace(output_dir: str) -> List[str]:
    """Write the ``mmlspark`` package; returns the generated file paths."""
    groups = _group_stages()
    written: List[str] = []
    root = os.path.join(output_dir, "mmlspark")

    def write(path: str, content: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content)
        written.append(path)

    ns_top = sorted({ns.split(".")[0] for ns in groups})
    write(os.path.join(root, "__init__.py"),
          '"""Generated by mmlspark_tpu_torch.codegen — do not edit."""\n'
          f"__all__ = {ns_top!r}\n")

    for ns, quals in sorted(groups.items()):
        imports, attach, names = [], [], []
        for qual in quals:
            module, name = qual.rsplit(".", 1)
            imports.append(f"from {module} import {name}")
            attach.append(f"_attach({name})")
            names.append(name)
            for alias in ALIASES.get(name, []):
                attach.append(f"{alias} = {name}")
                names.append(alias)
        parts = ns.split(".")
        for depth in range(1, len(parts)):
            init = os.path.join(root, *parts[:depth], "__init__.py")
            if not os.path.exists(init):
                write(init, '"""Generated by mmlspark_tpu_torch.codegen."""\n')
        write(os.path.join(root, *parts[:-1], parts[-1] + ".py"),
              _MODULE_TEMPLATE.format(
                  ns=ns, imports="\n".join(imports),
                  attach="\n".join(attach),
                  all_names=", ".join(repr(n) for n in names)))
    return written


def _write_text(output_path: str, content: str) -> str:
    """Shared emit epilogue for every generated artifact."""
    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        f.write(content)
    return output_path


def generate_api_docs(output_path: str) -> str:
    """Markdown API reference over every stage + param (docs leg)."""
    groups = _group_stages()
    lines = ["# mmlspark_tpu_torch generated API reference", "",
             "Generated by `mmlspark_tpu_torch.codegen` by reflection over "
             "every pipeline stage (the reference generates its docs and "
             "wrappers "
             "the same way: codegen/CodeGen.scala:13-68).", ""]
    stages = discover_stages()
    for ns, quals in sorted(groups.items()):
        lines.append(f"## mmlspark.{ns}")
        lines.append("")
        for qual in quals:
            cls = stages[qual]
            doc = (cls.__doc__ or "").strip().splitlines()
            lines.append(f"### {cls.__name__}")
            if doc:
                lines.append(doc[0])
            lines.append("")
            params = cls.params()
            if params:
                lines.append("| param | default | doc |")
                lines.append("|---|---|---|")
                for p in params:
                    d = "" if p.default is None else repr(p.default)
                    # param docs may contain literal pipes ("a | b" choice
                    # lists) — escape them or they split the table row
                    doc = (p.doc or "").replace("|", "\\|")
                    lines.append(f"| {p.name} | {d} | {doc} |")
                lines.append("")
    return _write_text(output_path, "\n".join(lines))


def generate_migration_table(output_path: str) -> str:
    """Class-by-class migration table: every stage the registry knows, its
    drop-in compat import (identical to the reference's PySpark import
    path), and the native module that implements it. Generated so the table
    can never drift from the real surface (the completeness analog of the
    reference's generated wrapper docs)."""
    groups = _group_stages()
    lines = [
        "# Migration table — MMLSpark class → mmlspark_tpu_torch",
        "",
        "Generated by `mmlspark_tpu_torch.codegen`. Every pipeline stage in",
        "the port, keyed by the reference package it mirrors. The compat",
        "import is drop-in: the same `from mmlspark.<ns> import <Class>`",
        "line a reference user already has (backed by the generated",
        "`build/python_api_torch/mmlspark`, the port's analog of the",
        "reference's generated PySpark wrappers).",
        "See `docs/migration.md` for the concept-level guide.",
        "",
    ]
    for ns, quals in sorted(groups.items()):
        lines.append(f"## mmlspark.{ns}")
        lines.append("")
        lines.append("| Class | Drop-in import | Native implementation |")
        lines.append("|---|---|---|")
        for qual in quals:
            module, cls = qual.rsplit(".", 1)
            lines.append(f"| {cls} | `from mmlspark.{ns} import {cls}` "
                         f"| `{module}.{cls}` |")
            # classes the reference knows under a different name get their
            # own row so a search for the reference name finds the mapping
            for alias in ALIASES.get(cls, ()):
                lines.append(
                    f"| {alias} (reference name) | `from mmlspark.{ns} "
                    f"import {alias}` | `{module}.{cls}` |")
        lines.append("")
    return _write_text(output_path, "\n".join(lines))


_TEST_TEMPLATE = '''"""Generated smoke tests — mmlspark_tpu_torch.codegen (do not edit).

PySparkWrapperTest.scala analog: every generated wrapper class default-
constructs and round-trips one param through its generated accessors.
"""

import pytest


CASES = [
{cases}
]


@pytest.mark.parametrize("modname,clsname", CASES)
def test_wrapper_smoke(modname, clsname):
    import importlib

    from mmlspark_tpu_torch.core.pipeline import PipelineStage

    mod = importlib.import_module(modname)
    cls = getattr(mod, clsname)
    stage = cls.__new__(cls)
    PipelineStage.__init__(stage)
    params = stage.params()
    if params:
        p = params[0]
        cap = p.name[0].upper() + p.name[1:]
        if p.default is not None:
            # defaults pass their own type converter and round-trip exactly
            getattr(stage, "set" + cap)(p.default)
            assert getattr(stage, "get" + cap)() == p.default
        else:
            assert getattr(stage, "get" + cap)() is None
'''


def generate_smoke_tests(output_path: str) -> str:
    groups = _group_stages()
    cases = []
    for ns, quals in sorted(groups.items()):
        for qual in quals:
            name = qual.rsplit(".", 1)[1]
            cases.append(f'    ("mmlspark.{ns}", "{name}"),')
    return _write_text(output_path,
                       _TEST_TEMPLATE.format(cases="\n".join(cases)))


_R_HEADER = '''# Generated by mmlspark_tpu_torch.codegen -- do not edit.
#
# R bindings for the mmlspark_tpu_torch framework (SparklyR-wrapper analog;
# reference: codegen/SparklyRWrapper.scala + src/main/R/ml_utils.R).
# The Python runtime is reached through {reticulate}; call
# mmlspark_initialize() once per session.

.mmlspark_env <- new.env(parent = emptyenv())

mmlspark_initialize <- function(python = NULL) {
  if (!requireNamespace("reticulate", quietly = TRUE)) {
    stop("the reticulate package is required for mmlspark_tpu_torch R bindings")
  }
  if (!is.null(python)) reticulate::use_python(python)
  .mmlspark_env$modules <- list()
  invisible(TRUE)
}

.mmlspark_module <- function(name) {
  if (is.null(.mmlspark_env$modules)) mmlspark_initialize()
  mod <- .mmlspark_env$modules[[name]]
  if (is.null(mod)) {
    mod <- reticulate::import(name)
    .mmlspark_env$modules[[name]] <- mod
  }
  mod
}
'''

_R_FN_TEMPLATE = '''
#' {title}
#'
#' Constructs a `{cls}` stage (Python class `{module}.{cls}`).
#' Named arguments become stage params; returns the stage object, whose
#' `fit(dataset)` / `transform(dataset)` methods mirror the Python API.
#' @export
{fn_name} <- function(...) {{
  mod <- .mmlspark_module("{module}")
  mod${cls}(...)
}}
'''


def _r_fn_name(name: str) -> str:
    out = []
    prev_upper = False
    for i, ch in enumerate(name):
        if ch.isupper():
            if i > 0 and not prev_upper:
                out.append("_")
            out.append(ch.lower())
            prev_upper = True
        else:
            out.append(ch)
            prev_upper = False
    return "ml_" + "".join(out)


def generate_r_wrappers(output_dir: str) -> List[str]:
    """SparklyR-style R wrappers: one ``ml_snake_case()`` constructor per
    stage, dispatching through reticulate (reference:
    codegen/SparklyRWrapper.scala generated R surface)."""
    groups = _group_stages()
    written: List[str] = []
    rdir = os.path.join(output_dir, "R")
    os.makedirs(rdir, exist_ok=True)
    core = os.path.join(rdir, "mmlspark_runtime.R")
    with open(core, "w") as f:
        f.write(_R_HEADER)
    written.append(core)
    for ns, quals in sorted(groups.items()):
        path = os.path.join(rdir, f"mmlspark_{ns.replace('.', '_')}.R")
        with open(path, "w") as f:
            f.write("# Generated by mmlspark_tpu_torch.codegen -- "
                    "do not edit.\n")
            for qual in quals:
                module, name = qual.rsplit(".", 1)
                f.write(_R_FN_TEMPLATE.format(
                    title=f"{name} ({ns})", cls=name, module=module,
                    fn_name=_r_fn_name(name)))
        written.append(path)
    return written


def generate_all(output_dir: str) -> Dict[str, object]:
    files = generate_compat_namespace(output_dir)
    docs = generate_api_docs(os.path.join(output_dir, "API_REFERENCE.md"))
    tests = generate_smoke_tests(
        os.path.join(output_dir, "test_generated_wrappers.py"))
    r_files = generate_r_wrappers(output_dir)
    migration = generate_migration_table(
        os.path.join(output_dir, "MIGRATION_TABLE.md"))
    return {"namespace_files": files, "docs": docs, "tests": tests,
            "r_files": r_files, "migration": migration}
