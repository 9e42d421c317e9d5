"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a``. Libraries land in ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source never loads a stale library. Builds start at
first use; :func:`build` compiles several sources in parallel, one ``nvcc``
process each. Every build passes ``-Xptxas -v`` and keeps the compiler's
output beside the library (``<name>-<hash>.ptxas.txt``), which
:func:`kernel_resources` reads: each ``__global__`` kernel's registers,
shared memory and spills, for the launch-geometry audit. :data:`COUNTS`
counts the builds and first loads of this process (the build sentinel,
``repro_torch.analysis.trace_guard``).

Nothing here runs at import: the CPU tests import every module of the
package on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {"ell_gather": "ell_gather.cu", "ell_push": "ell_push.cu",
           "frontier_crit": "frontier_crit.cu", "embed_grad": "embed_grad.cu"}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc builds and first library loads in this process
COUNTS = {"builds": 0, "loads": 0}
_count_lock = threading.Lock()


def _count(what: str) -> None:
    with _count_lock:
        COUNTS[what] += 1


def compile_count() -> int:
    """Builds plus first loads of a library in this process so far."""
    with _count_lock:
        return COUNTS["builds"] + COUNTS["loads"]


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


def ptxas_path(name: str) -> Path:
    """Where the build of ``SOURCES[name]`` keeps its compiler output."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(names=None) -> dict[str, str]:
    """Compile the named sources (default all) that are not built yet, one
    ``nvcc`` each, all at once. Returns ``{name: compiler output}`` for the
    sources compiled by this call (with ``-Xptxas -v``: registers, shared
    memory and spills per kernel), each also written to
    :func:`ptxas_path`. Raises with the compiler's output when a build
    fails."""
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[nm])]
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
            record = ptxas_path(nm)
            part = record.with_name(f"{record.name}.{os.getpid()}.tmp")
            part.write_text(out)
            os.replace(part, record)
            os.replace(tmp, final)  # atomic: a concurrent loader never sees half a file
            _count("builds")
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
        _count("loads")
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def kernel_name(mangled: str) -> tuple[str, tuple[int, ...]]:
    """``(name, template values)`` of an entry function's mangled name:
    ``_Z11scan_kernelILi8ELb1ELb0EEv...`` -> ``("scan_kernel", (8, 1,
    0))``; a name that is not mangled is its own name."""
    m = re.match(r"_Z(\d+)", mangled)
    if not m:
        return mangled, ()
    start = m.end()
    name = mangled[start:start + int(m.group(1))]
    rest = mangled[start + int(m.group(1)):]
    vals: list[int] = []
    if rest.startswith("I"):  # template values: literals L<type><value>E
        for m in re.finditer(r"L[a-z](n?)(\d+)E|(.)", rest[1:]):
            if m.group(3) is not None:  # the list's E, or a type argument
                break
            vals.append(-int(m.group(2)) if m.group(1) else int(m.group(2)))
    return name, tuple(vals)


def parse_ptxas(text: str) -> dict[str, dict]:
    """Each ``__global__`` kernel's resources in ``nvcc -Xptxas -v``
    output: ``{kernel: {registers, smem_bytes, spill_stores, spill_loads,
    instances}}``, the first four the most over the kernel's template
    instances and ``instances`` each instance's own, keyed by its template
    values."""
    entries: dict[str, dict] = {}
    spills: dict[str, tuple[int, int]] = {}
    current = props = None
    for line in text.splitlines():
        if (m := _ENTRY.search(line)) is not None:
            current = m.group(1)
            entries.setdefault(current, {})
        elif (m := _PROPS.search(line)) is not None:
            props = m.group(1)
        elif (m := _SPILL.search(line)) is not None and props is not None:
            spills[props] = (int(m.group(1)), int(m.group(2)))
        elif (m := _USED.search(line)) is not None and current is not None:
            sm = _SMEM.search(line)
            entries[current].update(registers=int(m.group(1)),
                                    smem_bytes=int(sm.group(1)) if sm else 0)
    out: dict[str, dict] = {}
    for mangled, res in entries.items():
        if "registers" not in res:
            continue
        stores, loads = spills.get(mangled, (0, 0))
        inst = dict(res, spill_stores=stores, spill_loads=loads)
        name, targs = kernel_name(mangled)
        row = out.setdefault(name, {"registers": 0, "smem_bytes": 0,
                                    "spill_stores": 0, "spill_loads": 0,
                                    "instances": {}})
        row["instances"][targs] = inst
        for key in ("registers", "smem_bytes", "spill_stores", "spill_loads"):
            row[key] = max(row[key], inst[key])
    return out


def kernel_resources(name: str) -> dict[str, dict]:
    """:func:`parse_ptxas` of the build record of ``SOURCES[name]``; raises
    ``FileNotFoundError`` when this checkout has not built it (the record
    exists only where ``nvcc`` ran)."""
    path = ptxas_path(name)
    if not path.exists():
        raise FileNotFoundError(f"no build record {path}: build {name!r} "
                                "on the machine with the card first")
    return parse_ptxas(path.read_text())
