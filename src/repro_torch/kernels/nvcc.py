"""Build a CUDA source of `csrc/` into a shared library and load it (ctypes).

Each source is compiled on its own, with nvcc for sm_90a, into the
package's git-ignored `_build/` directory at first use; the file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as built. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# build products stay inside the package's own (git-ignored) directory
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def build_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per content of the source and flags)
    and load it. Raises RuntimeError with nvcc's output when it fails."""
    src = CSRC / source
    tag = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so = BUILD_DIR / f"lib{src.stem}-{tag}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def raise_on(rc: int, name: str) -> None:
    """Raise when a C entry point returned a CUDA error code (0 = success)."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {rc})")
