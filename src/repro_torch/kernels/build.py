"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The build is keyed by a
hash of the sources and flags and goes to ``build/repro_torch/<hash>/`` at
the root of the checkout, a directory git ignores; a second call with the
same sources reuses it.  A missing ``nvcc`` or a failed build raises:
nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(DEFAULT_NVCC):
        return DEFAULT_NVCC
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def build_dir() -> Path:
    """Directory of the library for the current sources and flags."""
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cus + cuhs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel) is kept in ``build.log``."""
    out = build_dir()
    lib = out / LIB_NAME
    if lib.exists():
        return lib
    nvcc = _nvcc()
    cus, _ = _sources()
    tmp = out / f"tmp-{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    procs = [(cu, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", str(cu), "-o", str(tmp / (cu.stem + ".o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cu in cus]
    logs, failed = [], []
    for cu, p in procs:
        text, _ = p.communicate()
        logs.append(f"== {cu.name} (exit {p.returncode})\n{text}")
        if p.returncode:
            failed.append(cu.name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp / LIB_NAME),
         *[str(tmp / (cu.stem + ".o")) for cu in cus]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    (out / "build.log").write_text(log + link.stdout)
    os.replace(tmp / LIB_NAME, lib)
    shutil.rmtree(tmp, ignore_errors=True)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with the argument
    types of every C entry declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.repro_flash_attention.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    lib.repro_flash_attention.restype = i32
    lib.repro_flash_decode.argtypes = [ptr] * 6 + [i32] * 8 + [ptr]
    lib.repro_flash_decode.restype = i32
    lib.repro_onebit_encode_ef.argtypes = ([ptr] * 8 + [i32] * 2
                                           + [ctypes.c_float, i32, ptr])
    lib.repro_onebit_encode_ef.restype = i32
    lib.repro_onebit_compress.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
    lib.repro_onebit_compress.restype = i32
    lib.repro_topk_compress.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.repro_topk_compress.restype = i32
    lib.repro_terngrad.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
    lib.repro_terngrad.restype = i32
    lib.repro_terngrad_compress.argtypes = [ptr] * 5 + [i32] * 2 + [ptr]
    lib.repro_terngrad_compress.restype = i32
    lib.repro_qsgd_compress.argtypes = [ptr] * 4 + [i32] * 4 + [ptr]
    lib.repro_qsgd_compress.restype = i32
    return lib
