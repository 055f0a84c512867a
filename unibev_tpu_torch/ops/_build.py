"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``unibev_tpu_torch/csrc/*.cu`` file is compiled for Hopper (sm_90a),
one ``nvcc`` process per file, all started together, and the objects are
linked into one shared library with a plain C interface, ``build/kernels/
libunibev_kernels.so`` under the repository root, the first time a kernel is
launched in a process.  The library is rebuilt when the sources (``*.cu`` and
the ``*.cuh`` headers they include) or the flags change (a digest of both
sits beside it).  There is no fallback: a failed build raises.

Each C entry point launches on the stream it is given and returns the
``cudaGetLastError()`` after its launch; :func:`check` turns a non-zero code
into an exception.

``launches`` counts kernel launches by kernel name.  The wrappers in
``ops/msda.py``, ``ops/deform_conv.py``, ``ops/scatter.py`` and
``ops/sparse_conv.py`` add one where they launch and nowhere else, so a
caller can show that a run went through the kernels: ``msda_fwd`` (K1),
``dcn_fwd`` (K2, the fused DCN forward), ``dcn_im2col`` (the columns of the
DCN backward), ``msda_bwd`` (K3), ``dcn_bwd`` (K4), ``scatter_add_rows``
(K5), ``sparse_nbr`` (K6), ``sparse_conv`` (K7), ``sparse_inv_nbr`` (K8),
``sparse_conv_wgrad`` (K9).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE.parent / "build" / "kernels"
LIB_NAME = "libunibev_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# name -> argument types of the C entry point
_SIGNATURES = {
    # value, loc, attn, out, B, V, Q, heads, D, L, P, shapes, dtype, vec,
    # stream
    "unibev_msda_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I,
                        _P),
    # x, offset, mask, wt, out, partial, arrivals, max_blocks, B, H, W, Cin,
    # cin_pad, Ho, Wo, Cout, Kh, Kw, stride, pad, dil, smem_bytes, dtype,
    # stream
    "unibev_dcn_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, offset, mask, cols, B, H, W, Cin, Ho, Wo, Kh, Kw, stride, pad, dil,
    # dtype, stream
    "unibev_dcn_im2col": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _P),
    # value, loc, attn, grad, d_attn, d_loc, contrib, idx, B, V, Q, heads, D,
    # L, P, shapes, r0, n_rows, dtype, stream
    "unibev_msda_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _I, _P, _L, _L, _I, _P),
    # x, offset, mask, d_cols, d_offset, d_mask, contrib, idx, B, H, W, Cin,
    # Ho, Wo, Kh, Kw, stride, pad, dil, n0, n_pix, dtype, stream
    "unibev_dcn_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _L, _L, _I, _P),
    # idx, contrib, table, M, L, tr, dtype, stream
    "unibev_scatter_add_rows": (_P, _P, _P, _L, _I, _I, _I, _P),
    # table, coords, mask, out, Vout, D, H, W, kz, ky, kx, sz, sy, sx, pz,
    # py, px, sentinel, table_size, stream
    "unibev_sparse_nbr": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _L, _P),
    # feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, dtype, stream
    "unibev_sparse_conv": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # table, coords, mask, out, Vin, Do, Ho, Wo, kz, ky, kx, sz, sy, sx, pz,
    # py, px, sentinel, table_size, stream
    "unibev_sparse_inv_nbr": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _L, _P),
    # feats, nidx, g, dw, Vout, K, Cin, Cout, V, dtype, stream
    "unibev_sparse_conv_wgrad": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
}

launches: Counter = Counter()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sorted(sources + list(CSRC.glob("*.cuh"))):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile the kernels if the library is missing or stale; return its path."""
    sources = _sources()
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    digest = _digest(sources)
    if lib_path.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    log = "".join(logs) + link.stdout + link.stderr
    (BUILD_DIR / "nvcc.log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if any(p.returncode for p in procs) or link.returncode:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib_path)
    stamp.write_text(digest)
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def dtype_code(dtype) -> int:
    """The C entry points' dtype switch: 0 f32, 1 bf16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
