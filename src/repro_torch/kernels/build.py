"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, into an object file; one more ``nvcc`` links the objects
into a shared library with a plain C interface.  The library lands in
``build/repro_torch/<digest>/`` under the repository root, keyed by a
digest of the sources and flags, so a changed source builds anew and an
unchanged one loads what is there.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_LP = ctypes.POINTER(ctypes.c_longlong)
# C argument types of every exported function, each returning an int (a
# launcher its CUDA error); a launcher takes (pointers..., ints and
# floats..., its launch knobs (see ops), stream)
SIGNATURES = {
    "stump_scan_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _P],
    "stump_scan_batched_launch": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                                  _I, _P],
    "stump_vote_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stump_vote_fp_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P],
    "ensemble_vote_batched_launch": [_P, _P, _P, _L, _I, _I, _I, _P],
    "ensemble_vote_launch": [_P, _P, _P, _I, _I, _I, _P],
    "dist_update_launch": [_P, _F, _P, _P, _P, _P, _P, _P, _L, _I, _I, _I,
                           _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _LP, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _P],
}

_LIB: Optional[ctypes.CDLL] = None
ptxas_log = ""            # register/spill report of this process's build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source at first use on a CUDA machine")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources if their library is not built yet; returns the
    library's path."""
    global ptxas_log
    sources = sorted(CSRC.glob("*.cu"))
    out_dir = BUILD_ROOT / _digest(sources)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    nvcc = nvcc_path()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib),
             *[str(obj) for _src, obj, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)    # atomic: concurrent builders race safely
    ptxas_log = "\n".join(logs)
    return lib


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and cached."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB
