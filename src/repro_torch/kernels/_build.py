"""Build and load the port's CUDA kernels.

The sources in ``kernels/csrc`` are compiled at first use with ``nvcc``
for ``sm_90a`` into ONE shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` needs). Each ``.cu`` compiles
in its own ``nvcc`` process, all started together, then one link step.

The library lands in ``<repo>/build/kernels/<hash>/`` (git-ignored),
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads from disk. ``REPRO_TORCH_BUILD_DIR`` overrides the
location. Nothing here runs at import time: the CPU tests import every
module and have no ``nvcc``.
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
from typing import Dict, List, Optional, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C entry points and their argument types (see csrc/*.cu)
SIGNATURES: Dict[str, List] = {
    "rt_decode_attention_paged":
        [_P] * 8 + [_I] * 9 + [_F, _I, _P],
    "rt_decode_attention":
        [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    "rt_chunk_attention_paged":
        [_P, _P, _P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P],
    "rt_chunk_attention":
        [_P] * 5 + [_I] * 7 + [_F, _I, _P],
    "rt_flash_attention":
        [_P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P],
    "rt_ssd_scan":
        [_P] * 9 + [_I] * 6 + [_L] * 9 + [_I, _P],
    "rt_kv_probe":
        [_P] * 6 + [_I] * 10 + [_P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_info: Dict[str, object] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("repro_torch kernels: nvcc not found (needs the "
                       "CUDA toolkit; set NVCC or put nvcc on PATH)")


def _sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    root = os.environ.get("REPRO_TORCH_BUILD_DIR")
    base = Path(root) if root else REPO_ROOT / "build" / "kernels"
    return base / _digest()


def _compile(out: Path) -> str:
    """Compile every source in parallel, link, and return the compiler log
    (``-Xptxas -v`` register / shared-memory report included)."""
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="objs-", dir=out.parent))
    procs = []
    for src in _sources():
        obj = tmp / (src.stem + ".o")
        cmd = [nvcc, *ARCH_FLAGS, *CFLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {src.name}\n{text}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(log))
    lib_tmp = tmp / LIB_NAME
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib_tmp), *objs, "-ldl"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(lib_tmp, out)            # atomic: readers never see a stub
    shutil.rmtree(tmp, ignore_errors=True)
    return "\n".join(log)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        d = build_dir()
        lib_path = d / LIB_NAME
        t0 = time.perf_counter()
        built = not lib_path.exists()
        if built:
            _nvcc()                     # fail before touching the disk
            d.mkdir(parents=True, exist_ok=True)
            log = _compile(lib_path)
            (d / "build.log").write_text(log)
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rt_decode_plan.argtypes = [_I] * 7 + [_P]
        lib.rt_decode_plan.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        build_info.update(path=str(lib_path), built=built,
                          seconds=time.perf_counter() - t0)
        _lib = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        msg = _lib.rt_error_string(rc).decode() if _lib else ""
        raise RuntimeError(f"{name}: CUDA error {rc} at launch ({msg})")


# -- wrapper helpers ------------------------------------------------------------
HEAD_DIMS = (16, 32, 64, 80, 128)     # attention kernels (80: zamba2)
DTYPES = (torch.float32, torch.bfloat16)


def expect(cond: bool, what: str) -> None:
    """Raise on an input the kernels do not take."""
    if not cond:
        raise ValueError(what)


def expect_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    """q (B, Sq, nh, d) against K/V (rows, ..., nkv, d) the kernels take:
    one dtype of fp32 / bf16, a supported head dim, nh a multiple of nkv."""
    ok = (q.ndim == 4 and k.ndim == 4 and v.shape == k.shape
          and k.shape[3] == q.shape[3] and q.shape[3] in HEAD_DIMS
          and q.shape[2] % k.shape[2] == 0)
    expect(ok, f"{name}: unsupported shapes q={tuple(q.shape)} "
               f"k/v={tuple(k.shape)}")
    expect(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"{name}: q, k and v must share fp32 or bf16")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        expect(t.is_cuda and t.device == dev,
               f"{name}: every tensor must be on the same CUDA device")
        expect(t.is_contiguous(), f"{name}: inputs must be contiguous")


def row_vector(x: Union[int, torch.Tensor], b: int,
               device: torch.device) -> torch.Tensor:
    """A scalar or (B,) position argument as a contiguous (B,) int32."""
    x = torch.as_tensor(x, device=device)
    expect(x.ndim in (0, 1) and (x.ndim == 0 or x.shape[0] == b),
           f"expected a scalar or ({b},) vector, got {tuple(x.shape)}")
    return x.to(torch.int32).expand(b).contiguous()


def stream_ptr(device: torch.device) -> int:
    """PyTorch's current stream. Kernels launch on it, so the caching
    allocator's stream-ordered reuse keeps a wrapper's temporaries (the
    int32 positions, split-KV scratch) valid after the wrapper returns."""
    return torch.cuda.current_stream(device).cuda_stream
