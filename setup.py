"""Wheel build with native host-runtime (reference: build.sbt:196-247).

The C++ host runtime (native/mmlspark_native.cpp) is shipped two ways:
  1. as package data inside ``mmlspark_tpu/native/`` so installed trees can
     compile it on first use (the repo layout keeps it at the root);
  2. best-effort prebuilt into ``mmlspark_native_prebuilt.so`` when the build
     host has a C++ toolchain — missing toolchain is NOT an error, the
     runtime loader falls back to compile-on-use and then to pure Python.
"""

import os
import shutil
import subprocess

from setuptools import find_packages, setup
from setuptools.command.build_py import build_py

ROOT = os.path.dirname(os.path.abspath(__file__))
NATIVE_SRC = os.path.join(ROOT, "native", "mmlspark_native.cpp")


def _try_compile(src: str, out: str) -> bool:
    for cxx in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if not cxx:
            continue
        cmd = [cxx, "-O3", "-std=c++17", "-shared", "-fPIC", src, "-o", out]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
            return True
        except (OSError, subprocess.SubprocessError):
            continue
    return False


class build_py_with_native(build_py):
    def run(self):
        super().run()
        pkg_native = os.path.join(self.build_lib, "mmlspark_tpu", "native")
        os.makedirs(pkg_native, exist_ok=True)
        shutil.copy2(NATIVE_SRC,
                     os.path.join(pkg_native, "mmlspark_native.cpp"))
        _try_compile(NATIVE_SRC,
                     os.path.join(pkg_native, "mmlspark_native_prebuilt.so"))


packages = (find_packages(include=["mmlspark_tpu", "mmlspark_tpu.*"])
            + find_packages(include=["mmlspark_tpu_torch",
                                     "mmlspark_tpu_torch.*"])
            + ["mmlspark"]
            + ["mmlspark." + p
               for p in find_packages(where=os.path.join(ROOT, "python_api",
                                                         "mmlspark"))])

setup(
    packages=packages,
    package_dir={"mmlspark": "python_api/mmlspark"},
    package_data={
        "mmlspark_tpu.native": ["mmlspark_native.cpp",
                                "mmlspark_native_prebuilt.so"],
        # trained model fixtures served by ModelDownloader's package:// repo
        "mmlspark_tpu.models.dnn": ["fixtures/*.npz"],
        # the port's CUDA kernel sources, built with nvcc at first use
        "mmlspark_tpu_torch": ["csrc/*.cu", "csrc/*.cuh"],
        # the port's copy of the trained fixture (package:// repo)
        "mmlspark_tpu_torch.models.dnn": ["fixtures/*.npz"],
    },
    cmdclass={"build_py": build_py_with_native},
)
