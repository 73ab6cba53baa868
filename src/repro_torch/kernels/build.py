"""Build the CUDA kernels of ``csrc/`` at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` (Hopper; ``wgmma`` and ``setmaxnreg`` exist only
for that target).  The objects are linked into one shared library with a
plain C interface, so no source includes PyTorch's headers and the whole
build takes seconds.  The library lands in
``<repo>/build/kernels/<digest of the sources and flags>/``; a build that
finds its digest directory reuses it, and a new build is assembled in a
temporary directory and renamed into place, so concurrent processes never
load a half-written library.  ``ptxas -v`` reports each kernel's registers,
shared memory and spills; the build keeps them in ``build.log`` beside the
library (``build_log()``).

The C functions take raw pointers, strides and the CUDA stream
(``torch.cuda.current_stream().cuda_stream``), launch on that stream,
allocate nothing and return ``cudaGetLastError()``; ``check()`` raises on a
non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "kernels"
LIB_NAME = "libpipeboost_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C interface
DTYPE_F32 = 0
DTYPE_BF16 = 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # dtype, device, q, k, v, lens, k_new, v_new, slot_mask, out,
    # workspace, strides, B, Hq, Hkv, C, hd, splits, scale, stream
    "pb_decode_attention": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                            _STRIDES, _I, _I, _I, _I, _I, _I, _F, _P],
    # dtype, device, q, k, v, out, strides, B, Hq, Hkv, Sq, Sk, hd, causal,
    # window, q_offset, scale, stream
    "pb_flash_attention": [_I, _I, _P, _P, _P, _P, _STRIDES, _I, _I, _I, _I,
                           _I, _I, _I, _I, _I, _F, _P],
    # dtype, device, W, A, B, out, L, Din, Dout, r, scale, stream
    "pb_lora_merge": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    # dtype, device, x, dt, A, Bm, Cm, y, state, h0 (or null), workspace,
    # strides, B, S, H, P, N, P-block, stream
    "pb_ssd_scan": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _STRIDES,
                    _I, _I, _I, _I, _I, _I, _P],
    # device, log_a, bx, h0 (or null), y, h_T, strides, B, S, W, stream
    "pb_rglru_scan": [_I, _P, _P, _P, _P, _P, _STRIDES, _I, _I, _I, _P],
    # device, B, S, W, out: clusters the card holds at once
    "pb_rglru_max_active_clusters": [_I, _I, _I, _I, ctypes.POINTER(_I)],
    # dtype, device, x, residual (or null), w, h, s (or null), rows, D,
    # eps, stream
    "pb_rms_norm": [_I, _I, _P, _P, _P, _P, _P, _I, _I, _F, _P],
    # dtype, device, q, k, positions, inv_freq, q out, k out, strides, B,
    # Hq, Hkv, hd, stream
    "pb_rope_qk": [_I, _I, _P, _P, _P, _P, _P, _P, _STRIDES, _I, _I, _I, _I,
                   _P],
    # dtype, device, state, x, dt, dt_bias, A_log, Bm, Cm, D_skip, y,
    # strides, B, H, P, N, stream
    "pb_ssm_step": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _STRIDES,
                    _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_dir: Optional[Path] = None


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        p = Path(cand) / "bin" / "nvcc"
        if cand and p.exists():
            return str(p)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _compile(out_dir: Path) -> None:
    nvcc = nvcc_path()
    procs = []
    for src in sources():
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], []
    for src, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [str(obj) for _src, obj, _p in procs]
    if not failed:
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out_dir / LIB_NAME),
             *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log))


def build() -> Path:
    """Compile the kernels unless this digest was built; returns the
    directory holding the library and ``build.log``."""
    out_dir = BUILD_ROOT / _digest()
    if (out_dir / LIB_NAME).exists():
        return out_dir
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        _compile(tmp)
        try:
            os.rename(tmp, out_dir)
        except OSError:
            if not (out_dir / LIB_NAME).exists():   # not a lost race
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return out_dir


def load() -> ctypes.CDLL:
    """The bound kernel library (built on first call)."""
    global _lib, _lib_dir
    with _lock:
        if _lib is None:
            d = build()
            lib = ctypes.CDLL(str(d / LIB_NAME))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.pb_error_string.argtypes = [ctypes.c_int]
            lib.pb_error_string.restype = ctypes.c_char_p
            _lib, _lib_dir = lib, d
        return _lib


def build_log() -> str:
    """``nvcc``/``ptxas -v`` output of the build in use."""
    load()
    return (_lib_dir / "build.log").read_text()


def check(err: int, what: str) -> None:
    if err != 0:
        msg = load().pb_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def strides(*tensors_dims) -> ctypes.Array:
    """Pack strides (in elements) for the C interface: each argument is a
    ``(tensor, dims)`` pair, or ``(None, n)`` for n zero strides."""
    vals: List[int] = []
    for t, dims in tensors_dims:
        if t is None:
            vals.extend([0] * dims)
        else:
            vals.extend(int(t.stride(d)) for d in dims)
    return (ctypes.c_longlong * len(vals))(*vals)


def dtype_code(dtype) -> int:
    if dtype == torch.bfloat16:
        return DTYPE_BF16
    if dtype == torch.float32:
        return DTYPE_F32
    raise TypeError(f"kernels take bfloat16 or float32, not {dtype}")


def ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these inputs: grad mode is on and
    one of them requires a gradient.  The wrappers of the kernels on the
    train path then run their ``torch.autograd.Function``; otherwise they
    launch the kernel directly, as every serving path and captured decode
    step does."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)
