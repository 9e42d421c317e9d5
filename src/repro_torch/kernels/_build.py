"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``. Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source never loads a stale library. Builds start at
first use; :func:`build` compiles several sources in parallel, one ``nvcc``
process each.

Nothing here runs at import: the CPU tests import every module of the
package on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"ell_gather": "ell_gather.cu", "ell_push": "ell_push.cu",
           "frontier_crit": "frontier_crit.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
            "CUDA kernels are built from source on the machine with the card"
        )
    return path


def library_path(name: str) -> Path:
    """Where the library built from ``SOURCES[name]`` lives."""
    src = CSRC / SOURCES[name]
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=None, ptxas_info: bool = False) -> dict[str, str]:
    """Compile the named sources (default all) that are not built yet, one
    ``nvcc`` each, all at once. Returns ``{name: compiler output}`` for the
    sources compiled by this call; ``ptxas_info`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel) to that output.
    Raises with the compiler's output when a build fails."""
    names = tuple(SOURCES) if names is None else tuple(names)
    todo = [nm for nm in names if not library_path(nm).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for nm in todo:
        final = library_path(nm)
        tmp = final.with_name(f"{final.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / SOURCES[nm])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        procs[nm] = (proc, tmp, final)
    outputs, failed = {}, []
    for nm, (proc, tmp, final) in procs.items():
        out, _ = proc.communicate()
        outputs[nm] = out
        if proc.returncode != 0:
            failed.append(f"{nm} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, final)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outputs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed.

    ``signatures`` maps each C function to ``(argtypes, restype)``; every
    pointer and the stream are ``ctypes.c_void_p`` so ctypes never cuts a
    64-bit address to an int.
    """
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, (argtypes, restype) in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
