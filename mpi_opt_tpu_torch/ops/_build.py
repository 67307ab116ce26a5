"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into ``build/kernels/lib<name>-<digest>.so`` beside the
package (a directory git ignores); the digest is of the source and the
flags, so an edited source builds anew and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, ptxas report); 0.0 when reused
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build(name: str, src: Path | None = None) -> Path:
    """Compile ``csrc/<name>.cu`` (or ``src``) unless an up-to-date
    library exists."""
    src = Path(src) if src is not None else CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        BUILD_INFO.setdefault(name, (0.0, ""))
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO[name] = (time.perf_counter() - t0, proc.stderr)
    return out


def load(name: str, signatures: dict, src: Path | None = None) -> ctypes.CDLL:
    """The built library, with ``argtypes`` set from ``signatures``
    (function name -> list of ctypes types); every function returns a
    CUDA error code as int. ``src`` builds another source under ``name``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name, src)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
