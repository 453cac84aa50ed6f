"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``ray_tpu_torch/csrc/*.cu`` file becomes its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds rather
than minutes). The libraries go to ``build/ray_tpu_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an edit to any
source rebuilds on the next first use. All sources compile in parallel,
one ``nvcc`` each.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine without ``nvcc``. A missing ``nvcc`` or a failed
build raises; there is no fallback to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"

NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def find_nvcc() -> str:
    """The toolkit's ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``. Raises if there is none."""
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = []
    if cuda_home:
        candidates.append(os.path.join(cuda_home, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append(NVCC_FALLBACK)
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("ray_tpu_torch: nvcc not found (set CUDA_HOME or put "
                       "nvcc on PATH); the CUDA kernels cannot be built")


def _sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _digest() -> str:
    """One hash over every source and header and the flags: a change to a
    shared header rebuilds all libraries."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{_digest()}.so"


def build_all() -> Dict[str, float]:
    """Compile every stale source, all ``nvcc`` processes at once. Returns
    seconds spent per library built (empty when everything was current).
    ``nvcc``'s output, ``-Xptxas -v`` register and spill lines included,
    is kept beside each library as ``<lib>.log``."""
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, src in _sources().items():
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out, cmd)
    times, failed = {}, []
    for name, (proc, tmp, out, cmd) in procs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
        times[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("ray_tpu_torch: nvcc failed:\n" + "\n".join(failed))
    return times


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if stale."""
    if name not in _sources():
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    lib.rtt_error_string.argtypes = [ctypes.c_int]
    lib.rtt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.rtt_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")
