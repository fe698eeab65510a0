"""Build a CUDA source of `csrc/` into a shared library and load it (ctypes).

Each source is compiled on its own, with nvcc for sm_90a, into the
package's git-ignored `_build/` directory at first use; the file name
carries a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is loaded as built. ptxas's report (registers, shared
memory and spills of every kernel) is kept beside each library and read by
`ptxas_report`. Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
# build products stay inside the package's own (git-ignored) directory
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


def _library(source: str) -> Path:
    src = CSRC / source
    tag = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{tag}.so"


def build_library(source: str) -> ctypes.CDLL:
    """Compile `csrc/<source>` (once per content of the source and flags)
    and load it. Raises RuntimeError with nvcc's output when it fails."""
    so = _library(source)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {source} ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        so.with_suffix(".ptxas.txt").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def ptxas_report(source: str) -> list:
    """One line per kernel of the built `csrc/<source>`: registers, spill
    stores and loads, static shared memory, from ptxas's -v report."""
    log = _library(source).with_suffix(".ptxas.txt")
    if not log.exists():
        return [f"{source}: no ptxas report (the library was built elsewhere)"]
    rows, name, spills = [], None, ""
    for line in log.read_text().splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spills = f"{m.group(1)} B spill stores, {m.group(2)} B spill loads"
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append((name, f"{m.group(1)} registers, {spills}, "
                               f"{smem.group(1) if smem else 0} B static smem"))
            name, spills = None, ""
    filt = Path(_nvcc()).parent / "cu++filt"
    names = [n for n, _ in rows]
    if filt.exists() and names:
        res = subprocess.run([str(filt), *names], capture_output=True, text=True)
        if res.returncode == 0 and len(res.stdout.splitlines()) == len(names):
            names = res.stdout.splitlines()
    return [f"{n}: {info}" for n, (_, info) in zip(names, rows)]


def raise_on(rc: int, name: str, codes: dict = None) -> None:
    """Raise when a C entry point returned an error code (0 = success):
    CUDA's own, or one of the entry point's negative codes named in
    `codes`."""
    if rc != 0:
        what = (codes or {}).get(rc, f"CUDA error {rc}")
        raise RuntimeError(f"{name}: kernel launch failed ({what})")
