"""Build the CUDA kernels of ``kmerlsh_tpu_torch/csrc`` and load them.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, which ``ctypes`` loads. The library
name carries a hash of the sources and flags: a changed source builds anew
at first use, an unchanged one loads the library already built. The build
goes to ``build/kmerlsh_tpu_torch/`` at the root of the checkout.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kmerlsh_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry points and their argument types (every pointer and the stream as
# c_void_p: a plain int would be cut to 32 bits)
SIGNATURES = {
    "kl_transform": (_P, _P, _I, _L, _F, _P, _P, _P),
    "kl_lsh_keys": (_P, _L, _I, _L, _P, _P, _I, _I, _P, _P, _P, _P),
    "kl_permute_state": (_P, _L, _I, _L, _P, _P, _P, _P, _P, _P, _P),
    "kl_chain_collapse": (_P, _I, _L, _P, _P, _P, _P, _F, _I, _P, _P, _P,
                          _P, _P, _P),
    "kl_finalize_keys": (_L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "kl_finalize_gather": (_L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    "kl_wrs_verdicts": (_P, _L, _L, _I, _I, _P, _F, _F, _I, _P, _P, _P, _P),
    "kl_score_reads": (_P, _P, _P, _P, _I, _P, _L, _I, _F, _P, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of the build in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libkmerlsh_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [os.path.join(work, p.stem + ".o") for p in _sources()]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(_sources(), objs)]
        errors = []
        for src, proc in zip(_sources(), procs):
            _, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name} ({proc.returncode}):\n{err[-4000:]}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = os.path.join(work, "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
        os.replace(lib, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The kernels' library, built at first use and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
