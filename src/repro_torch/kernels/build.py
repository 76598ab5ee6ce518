"""Build and load the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each ``.cu`` source in ``csrc/`` is compiled at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a shared
library with a plain C interface, under ``build/kernels/`` at the root of
the checkout. The file name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. :func:`build_all` runs one nvcc for
each source, all at once.
Nothing here runs at import: the CPU tests import every module, and this
machine may have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

# IEEE division and square root, no FMA contraction: the kernels must
# equal their plain PyTorch versions bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-prec-div=true", "-prec-sqrt=true", "-lineinfo")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    data = src.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(data + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build(source: str, verbose: bool = False) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / source)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source}:\n{res.stderr}")
        if verbose and res.stderr:
            print(res.stderr.strip())
        os.replace(tmp, out)          # atomic: a reader sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(sources, verbose: bool = False):
    """Build several sources at once, one nvcc each; their library paths
    in the order given."""
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return list(pool.map(lambda s: build(s, verbose), sources))


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library."""
    return ctypes.CDLL(str(build(source)))
