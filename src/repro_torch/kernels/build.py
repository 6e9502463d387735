"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, at first use, from the
sources in the repository only, and loaded with ``ctypes``. The library's
file name carries a hash of its source and flags, so an edited source is
rebuilt and a stale library is never loaded. Nothing here runs at import:
the modules import (and the CPU tests run) on machines without ``nvcc``.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# libraries loaded in this process, by kernel name
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _source_bytes(path: Path) -> bytes:
    """The source's bytes and those of the files of ``csrc/`` it includes
    by ``#include "..."`` (a library built from a source that includes
    another is rebuilt when either changes)."""
    src = path.read_bytes()
    for inc in re.findall(rb'^#include "([^"]+)"', src, re.M):
        src += _source_bytes(path.parent / inc.decode())
    return src


def library_path(name: str, csrc: Path = CSRC,
                 build_dir: Path = BUILD_DIR) -> Path:
    src = _source_bytes(Path(csrc) / f"{name}.cu")
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str], csrc: Path = CSRC,
          build_dir: Path = BUILD_DIR) -> Dict[str, str]:
    """Compile every named kernel that has no current library, one nvcc
    process per source, all started together (the sources of ``csrc``,
    the libraries in ``build_dir``: the repository's own by default).
    Returns {name: compiler diagnostics} (the ``-Xptxas=-v`` register/spill
    report) for the ones it built. Raises RuntimeError, with nvcc's output,
    if any build fails."""
    csrc, build_dir = Path(csrc), Path(build_dir)
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name, csrc, build_dir)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    report, failed = {}, []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
        report[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str, signatures: Dict[str, Tuple[object, list]]
         ) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built first if needed), with
    ``restype``/``argtypes`` set from ``signatures`` {fn: (restype,
    argtypes)}."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = _LOADED[name] = open_library(library_path(name), signatures)
    return lib


@contextlib.contextmanager
def using(libs: Dict[str, ctypes.CDLL]):
    """Inside the block ``load`` returns ``libs`` {kernel name: loaded
    library} for their names (another tree's build of them, say); after
    it, the libraries it returned before."""
    saved = {n: _LOADED.get(n) for n in libs}
    _LOADED.update(libs)
    try:
        yield
    finally:
        for n, lib in saved.items():
            if lib is None:
                _LOADED.pop(n, None)
            else:
                _LOADED[n] = lib


def open_library(path, signatures: Dict[str, Tuple[object, list]]
                 ) -> ctypes.CDLL:
    """The library at ``path``, loaded, with ``restype``/``argtypes`` set
    from ``signatures``."""
    lib = ctypes.CDLL(str(path))
    for fn, (restype, argtypes) in signatures.items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    return lib
