"""Builds the port's CUDA kernels from the sources in the checkout.

Every ``csrc/*.cu`` has a plain C interface.  ``nvcc`` compiles each into
its own shared library for Hopper (``sm_90a``), and :func:`load` opens it
with ``ctypes``.  The build runs at first use, into
``build/repro_torch_kernels/`` at the repository root, keyed by a hash of
the sources and flags, so a changed source rebuilds and an unchanged one
loads what is there.  All sources compile at once, one ``nvcc`` each.
A build that fails raises: nothing runs on without its kernel.
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
from typing import Dict

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: kernel name -> source file under ``csrc/``
SOURCES = {
    "flash_attention": "flash_attention.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "decode_attention": "decode_attention.cu",
    "mamba_scan": "mamba_scan.cu",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: per kernel: seconds its nvcc took in this process (0.0 when the library
#: was already built) and the ptxas report (registers, shared memory)
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot build")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / SOURCES[name]).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel whose library is missing, all at once; returns
    :data:`build_info`."""
    with _lock:
        todo = [n for n in SOURCES if not lib_path(n).exists()]
        for n in SOURCES:
            if n not in todo and n not in build_info:
                log = lib_path(n).with_suffix(".log")
                build_info[n] = {"seconds": 0.0, "ptxas": log.read_text()
                                 if log.exists() else ""}
        if not todo:
            return build_info
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = lib_path(n)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (p, tmp, out) in procs.items():
            text, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{text}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(text)
            build_info[n] = {"seconds": time.perf_counter() - t0,
                             "ptxas": text}
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return build_info


def aligned16(t):
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary: the kernels read 16-byte vectors and TMA boxes."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    if name not in _libs:
        path = lib_path(name)
        if not path.exists():
            build_all()
        with _lock:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]
