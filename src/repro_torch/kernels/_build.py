"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into its own shared library,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

and loaded with ``ctypes``.  No PyTorch header is included, so a build
takes seconds.  ``-Xptxas -v`` makes ptxas report each kernel's
registers, shared memory and spills; :data:`BUILD_LOGS` keeps that output
of the builds this process ran.  The library name carries a hash of the
source, so an edited source is rebuilt; the build directory
(``kernels/build/``) is listed in ``.gitignore``.  ``--use_fast_math`` is
deliberately absent: the kernels must round as the plain versions do.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("seg_waterfill", "fw_minplus", "flash_attention", "ssd_scan",
           "place_round")

_loaded: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}    # kernel name -> nvcc's output


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source on the machine with the card")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def _start(name: str):
    """Start one nvcc into a temporary file; returns (process, tmp, out)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names=SOURCES) -> None:
    """Compile the named kernels, one nvcc each, all started together."""
    jobs = {n: j for n in names if (j := _start(n)) is not None}
    errors = []
    for name, (proc, tmp, out) in jobs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
