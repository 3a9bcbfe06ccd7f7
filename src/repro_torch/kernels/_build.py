"""Build the CUDA sources in ``csrc/`` into shared libraries, at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface. ``nvcc`` compiles it
for sm_90a into ``build/kernels/<name>-<hash>.so`` at the repository root
(a directory ``.gitignore`` lists), and the library is loaded with ctypes.
The hash covers the source, every ``csrc/*.cuh`` header it includes
(``#include "..."``, followed through headers), and the flags, so an edited
source or header rebuilds each library that uses it and a stale library is
never loaded. Nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_attention", "packed_gemm", "rmsnorm", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[Tuple[str, str], Callable] = {}
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _source_bytes(path: Path, seen: set) -> bytes:
    """``path``'s bytes followed by those of each header it includes from
    ``csrc``, depth first, each header once."""
    data = path.read_bytes()
    parts = [data]
    for inc in _INCLUDE.findall(data):
        dep = CSRC / inc.decode()
        if dep.exists() and dep not in seen:
            seen.add(dep)
            parts.append(_source_bytes(dep, seen))
    return b"".join(parts)


def library_path(name: str) -> Path:
    src = _source_bytes(CSRC / f"{name}.cu", set())
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. Returns the compiler output
    (with ``-Xptxas -v``: registers, shared memory and spills per kernel)
    of each source it compiled; raises if any compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def entry(name: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C function ``symbol`` of ``csrc/<name>.cu`` returning an int,
    bound once with ``argtypes`` (ctypes rebuilds its converters each time
    ``argtypes`` is set, which a wrapper would otherwise pay per launch)."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return fn


def reject_dtensor(name: str, *tensors) -> None:
    """Raise if any of ``tensors`` is a DTensor. A kernel takes plain local
    tensors: under a mesh the model's blocks (``attention_block``, the
    Mamba2 block) call it inside ``local_map`` on each rank's shard, and a
    DTensor never reaches it as a quiet copy to a replicated tensor."""
    from repro_torch.distributed.sharding import is_dtensor
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; run the kernel inside "
                        f"local_map on each rank's local shard")
