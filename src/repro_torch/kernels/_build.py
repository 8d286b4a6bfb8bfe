"""Build and load the port's CUDA kernels.

The sources in ``kernels/csrc`` are compiled at first use with ``nvcc``
for ``sm_90a`` into ONE shared library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds, not the
minutes ``torch.utils.cpp_extension.load`` needs). Each ``.cu`` compiles
in its own ``nvcc`` process, all started together, then one link step.

The library lands in ``<repo>/build/kernels/<hash>/`` (git-ignored),
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads from disk. ``REPRO_TORCH_BUILD_DIR`` overrides the
location. A first build is single across threads (a lock) and across
processes (an exclusive ``flock`` on ``<hash>.lock`` beside the build
directory): ranks started together wait for one build and load it.
Nothing here runs at import time: the CPU tests import every module and
have no ``nvcc``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
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
        [_P] * 8 + [_I] * 8 + [_F, _I, _I, _P],
    "rt_chunk_attention_paged":
        [_P, _P, _P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P],
    "rt_chunk_attention":
        [_P] * 5 + [_I] * 7 + [_F, _I, _P],
    "rt_flash_attention":
        [_P] * 5 + [_I] * 8 + [_F, _I, _P],
    "rt_flash_attention_bwd":
        [_P] * 10 + [_I] * 8 + [_F, _I, _P],
    "rt_ssd_scan":
        [_P] * 10 + [_I] * 6 + [_L] * 9 + [_I, _P, _P],
    "rt_ssd_scan_bwd":
        [_P] * 15 + [_I] * 6 + [_L] * 9 + [_I, _P],
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


@contextlib.contextmanager
def _file_lock(path: Path):
    """An exclusive lock on ``path`` held across processes."""
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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
        built = False
        if not lib_path.exists():
            _nvcc()                     # fail before touching the disk
            with _file_lock(d.parent / f"{d.name}.lock"):
                if not lib_path.exists():   # another process may have won
                    built = True
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
        lib.rt_flash_attention_bwd_plan.argtypes = [_I] * 9 + [_P]
        lib.rt_flash_attention_bwd_plan.restype = ctypes.c_int
        lib.rt_ssd_scan_bwd_plan.argtypes = [_I] * 7 + [_L] * 7 + [_I, _P]
        lib.rt_ssd_scan_bwd_plan.restype = ctypes.c_int
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
# the attention kernels' head dims (80: zamba2; 120: h2o-danube-3-4b)
HEAD_DIMS = (16, 32, 64, 80, 120, 128)
DTYPES = (torch.float32, torch.bfloat16)
# fp8 K/V caches (the reference's kv_cache_dtype) and their code in
# rt_decode_attention's kv_fmt (0: the cache has q's dtype)
KV_FORMATS = {torch.float8_e4m3fn: 1, torch.float8_e5m2: 2}


def expect(cond: bool, what: str) -> None:
    """Raise on an input the kernels do not take."""
    if not cond:
        raise ValueError(what)


def expect_attention(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, fp8_kv: bool = False) -> None:
    """q (B, Sq, nh, d) against K/V (rows, ..., nkv, d) the kernels take:
    one dtype of fp32 / bf16, a supported head dim, nh a multiple of nkv;
    with ``fp8_kv`` (the contiguous decode kernel) also K/V of one fp8
    dtype under fp32 or bf16 queries."""
    ok = (q.ndim == 4 and k.ndim == 4 and v.shape == k.shape
          and k.shape[3] == q.shape[3] and q.shape[3] in HEAD_DIMS
          and q.shape[2] % k.shape[2] == 0)
    expect(ok, f"{name}: unsupported shapes q={tuple(q.shape)} "
               f"k/v={tuple(k.shape)}")
    if k.dtype in KV_FORMATS:
        expect(fp8_kv, f"{name}: an fp8 K/V cache ({k.dtype}) is read by "
                       f"the contiguous decode kernel (decode_attention) "
                       f"only")
        expect(q.dtype in DTYPES and v.dtype == k.dtype,
               f"{name}: q must be fp32 or bf16 and k, v share one fp8 "
               f"dtype")
        return
    expect(q.dtype in DTYPES and k.dtype == q.dtype and v.dtype == q.dtype,
           f"{name}: q, k and v must share fp32 or bf16")


# what the serving kernels' gradient refusal names as missing
SERVING = ("a serving kernel; training differentiates flash attention and "
           "the SSD scan only")


def refuse_grad(name: str, *tensors, missing: str) -> None:
    """Raise when autograd is recording and an input requires grad. A
    kernel writes its output through ctypes, so the output has no
    ``grad_fn``: without this check a model on the card would silently
    drop every gradient upstream of the call. ``missing`` names the
    backward the kernel lacks."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and this kernel has no "
            f"backward ({missing}); run it under torch.no_grad() or on "
            f"tensors that do not require grad")


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
