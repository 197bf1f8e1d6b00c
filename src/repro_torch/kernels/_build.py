"""Build and load the hand-written CUDA kernels under csrc/.

Each `csrc/*.cu` is compiled by `nvcc` for `sm_90a` into a shared library
with a plain C interface and loaded with `ctypes`. The build happens at the
first launch, from the sources in the checkout only, into
`build/repro_torch_kernels/` at the repository root. Each library's file
name carries a hash of its source, the shared header and the flags, so a
changed source is rebuilt and an unchanged one is loaded as it is. All
missing libraries are compiled at once, one `nvcc` process each.

There is no fallback: a missing `nvcc` or a failed compile raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every entry point: (argtypes). Each returns an int: the
# launchers a cudaError_t, the `*_smem` functions a block's dynamic shared
# memory in bytes.
SIGNATURES = {
    "page_scan": {
        "page_scan_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "page_scan_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "page_scan_smem": (_I,),
    },
    "page_adc": {
        "page_adc_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "page_adc_smem": (_I,),
    },
    "fused_page_rank": {
        "fused_page_rank_f32": (_P,) * 7 + (_I,) * 5 + (_P,),
        "fused_page_rank_bf16": (_P,) * 7 + (_I,) * 5 + (_P,),
        "fused_page_rank_smem": (_I, _I),
    },
    "pq_adc": {
        "pq_adc_f32": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
    "merge_topl": {
        "merge_topl": (_P, _P, _P, _I, _I, _I, _I, _I, _LL, _F, _P, _P, _P,
                       _P),
    },
}

_loaded: dict = {}
build_log: dict = {}     # source name -> nvcc's -Xptxas -v report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch are "
                       "built from source and need the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for part in ((CSRC / f"{name}.cu").read_bytes(),
                 (CSRC / "common.cuh").read_bytes(),
                 " ".join(NVCC_FLAGS).encode()):
        h.update(part)
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every library that is not built yet, in parallel. Returns
    the seconds spent; raises with nvcc's output if a compile fails."""
    t0 = time.perf_counter()
    todo = [n for n in SIGNATURES if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        dst = _lib_path(name)
        tmp = dst.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, dst, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, dst, tmp, proc in procs:
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu:\n{out}")
        else:
            os.replace(tmp, dst)
    if failed:
        raise RuntimeError("\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib
