"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with ctypes.  The libraries go to
`build/kernels/` at the root of the checkout, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
loaded as it is.  All missing libraries are compiled at once, one `nvcc`
process per source.  Nothing is built when a module is imported: the first
launch of a kernel builds them.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("pim_attention", "pim_decode", "pim_matmul", "lut_softmax")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel launches per wrapper name; a wrapper adds one where it launches
# its kernel and nowhere else
LAUNCHES: collections.Counter = collections.Counter()

_loaded: Dict[str, ctypes.CDLL] = {}
# what the last `build_all` did: seconds spent and nvcc's ptxas report
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + \
            [Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc was not found: the CUDA kernels cannot be "
                           "built (set CUDA_HOME to the CUDA toolkit)")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in `names` that is not built yet, all `nvcc`
    processes at once; raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    t0 = time.perf_counter()
    procs = {}
    nvcc = _nvcc() if todo else ""
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        build_info[f"nvcc_{n}"] = out
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, paths[n])
    build_info["seconds"] = time.perf_counter() - t0
    build_info["built"] = list(todo)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed, with `argtypes`
    set from `signatures` and an int (a cudaError_t) returned by each."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all()[name]
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
