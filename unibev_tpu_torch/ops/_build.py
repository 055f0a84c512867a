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
``ops/msda.py``, ``ops/deform_conv.py``, ``ops/scatter.py``,
``ops/sparse_conv.py``, ``ops/voxelize.py``, ``ops/frozen_bn.py`` and
``core/bbox/lsa.py`` add one where they launch and nowhere else, so a caller
can show that a run went through the kernels: ``msda_fwd`` (K1),
``dcn_fwd`` (K2, the fused DCN forward), ``dcn_im2col`` (the columns of the
DCN backward), ``msda_bwd`` (K3), ``dcn_bwd`` (K4), ``scatter_add_rows`` (K5),
``sparse_nbr`` (K6), ``sparse_conv`` (K7), ``sparse_inv_nbr`` (K8),
``sparse_conv_wgrad`` (K9), ``voxelize`` (K10, one cloud a call),
``active_set`` (K11, one compact table a call), ``lsa`` (K12, the
head's Hungarian assignment: every problem of a loss in one call, one
block each) and ``frozen_bn_act`` (K13, a frozen BN of the camera backbone
with its ReLU and residual add, one pass a site).  A C entry point may
launch several ``__global__`` functions (K10, K11): it counts once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import NamedTuple

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
_F = ctypes.c_float
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
    # dtype, vec, lanes, pixels, stream
    "unibev_dcn_im2col": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _P),
    # value, loc, attn, grad, d_attn, d_loc, table, B, V, Q, heads, D, L, P,
    # shapes, dtype, vec, lanes, stream
    "unibev_msda_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _P, _I, _I, _I, _P),
    # x, offset, mask, d_cols, d_offset, d_mask, table, B, H, W, Cin, Ho, Wo,
    # Kh, Kw, stride, pad, dil, dtype, vec, lanes, stream
    "unibev_dcn_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # idx, contrib, table, M, L, tr, dtype, stream
    "unibev_scatter_add_rows": (_P, _P, _P, _L, _I, _I, _I, _P),
    # bits, base, rows, n_rows, coords, mask, out, Vout, D, H, W, kz, ky, kx,
    # sz, sy, sx, pz, py, px, sentinel, size, stream
    "unibev_sparse_nbr": (_P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _I, _I, _I, _I, _L, _P),
    # feats, nidx, weight, mask, out, Vout, K, Cin, Cout, V, dtype, stream
    "unibev_sparse_conv": (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    # bits, base, rows, n_rows, coords, mask, out, Vin, Do, Ho, Wo, kz, ky,
    # kx, sz, sy, sx, pz, py, px, sentinel, size, stream
    "unibev_sparse_inv_nbr": (_P, _P, _P, _I, _P, _P, _P, _L, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _L, _P),
    # feats, nidx, g, dw, Vout, K, Cin, Cout, V, dtype, kc, bn, span, chunk,
    # smem_bytes, stream
    "unibev_sparse_conv_wgrad": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _P),
    # points, mask, out, work, plan, plan fields, cell, stream
    "unibev_voxelize": (_P, _P, _P, _P, _P, _I, _P, _P),
    # coords, mask, work, plan, plan fields, stream
    "unibev_active_set": (_P, _P, _P, _P, _I, _P),
    # cost, valid, col4row, P, R, C, stream
    "unibev_lsa": (_P, _P, _P, _I, _I, _I, _P),
    # x, r, d, out, w, b, mean, var, eps, wd, bd, meand, vard, epsd, n, C,
    # form, dtype, buf_dtype, sms, stream
    "unibev_frozen_bn_act": (_P, _P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _P,
                             _P, _F, _L, _I, _I, _I, _I, _I, _P),
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


def raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as the handle a C entry
    point takes.  ``torch.cuda.current_stream().cuda_stream`` gives the same
    handle but builds a Stream object first: 7 us of host a call on the H100
    machine against 0.16 (K13's wrapper, which runs 100 times a forward)."""
    return torch._C._cuda_getCurrentRawStream(index)


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


def access_width(row_bytes: int, itemsize: int, *addresses: int,
                 most: int = 16) -> int:
    """The widest vector access, in bytes, of 16, 8 and 4 (at most
    ``most``) that divides a row of ``row_bytes`` and every address, else
    one element."""
    return next(n for n in (16, 8, 4, itemsize)
                if n <= max(most, itemsize) and row_bytes % n == 0
                and all(a % n == 0 for a in addresses))


def group_lanes(chunks: int) -> int:
    """Threads that share one item of ``chunks`` vector chunks in the
    sampling backwards (``group_lanes`` in ``csrc/bilinear.cuh``): the chunks
    rounded up to a power of two, at most a warp."""
    lanes = 1
    while lanes < chunks and lanes < 32:
        lanes *= 2
    return lanes


# words of one scan tile of an occupancy bitmap (kTileWords of
# csrc/bitmap.cuh): K10 and K11 zero and scan their bitmaps in whole tiles
BITMAP_TILE_WORDS = 8192


def bitmap_words(cells: int):
    """(words, padded) of an occupancy bitmap of ``cells`` cells: 32 cells a
    word, and the words rounded up to whole scan tiles, the length at which
    K10 and K11 allocate, zero and scan it."""
    words = -(-cells // 32)
    return words, -(-words // BITMAP_TILE_WORDS) * BITMAP_TILE_WORDS


# threads a block of K10's and K11's stages and of their fill (kThreads and
# kFillThreads of csrc/voxelize.cu, csrc/active_set.cu, csrc/bitmap.cuh)
BITMAP_THREADS = 256


def bitmap_blocks(n: int, fill: bool = False) -> int:
    """Blocks of BITMAP_THREADS for ``n`` items; a fill's grid strides past
    4096 blocks (``fill_blocks`` of csrc/bitmap.cuh)."""
    blocks = -(-n // BITMAP_THREADS)
    return min(blocks, 4096) if fill else blocks


def scan_state_words(tiles: int) -> int:
    """int32 words of the scan state of a bitmap of ``tiles`` scan tiles
    (``scan_state_words`` of csrc/bitmap.cuh): a 64-bit status word a tile,
    the ticket and the total, rounded up to 16 bytes."""
    return -(-(2 * tiles + 2) // 4) * 4


@functools.lru_cache(maxsize=None)
def plan_args(plan: tuple):
    """A launch plan (a NamedTuple of ints) as the int64 array its C entry
    point reads, made once per plan."""
    return (ctypes.c_longlong * len(plan))(*plan)


# the H100's L2 cache, against which the backwards' f32 tables are sized
L2_BYTES = 50 * 2 ** 20
# the most dynamic shared memory a block may use on the H100 (227 KB;
# kMaxSmemBytes of csrc/tensor_core.cuh)
MAX_SMEM_BYTES = 232448


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device ``index``, for the plans that size their grid
    to one wave (``dcn_fwd``, K9's wide tiles)."""
    return torch.cuda.get_device_properties(index).multi_processor_count

BWD_THREADS = 256   # kBwdThreads of csrc/msda.cu and csrc/deform_conv.cu


class BwdPlan(NamedTuple):
    """How a sampling backward (K3, K4) covers one call: ``lanes`` threads
    per item, each owning ``chunks_per_lane`` chunks of ``vec_bytes`` bytes
    of the item's row; ``blocks`` of ``threads`` threads; the f32 table of
    ``table_bytes``, which fits the L2 beside the map it is the gradient of
    (``map_bytes``) when ``l2_resident``."""
    vec_bytes: int
    lanes: int
    chunks_per_lane: int
    threads: int
    blocks: int
    table_bytes: int
    map_bytes: int
    l2_resident: bool


def bwd_plan(items: int, row: int, itemsize: int, addresses, map_elems: int,
             chunks_per_lane: int = 1) -> BwdPlan:
    """The plan of a sampling backward over ``items`` items of ``row``
    elements: at most 4 elements an access (8 bytes in bf16), so that each
    chunk's f32 adds are one 16-byte reduction, narrowed where the row or
    an address does not allow it; the row's chunks over ``chunks_per_lane``
    rounded up to a power of two threads per item, at most a warp (the C
    entry points refuse other lanes); one thread per lane of every item."""
    vec = access_width(row * itemsize, itemsize, *addresses,
                       most=4 * itemsize)
    chunks = row * itemsize // vec
    lanes = group_lanes(-(-chunks // chunks_per_lane))
    table, values = 4 * map_elems, itemsize * map_elems
    return BwdPlan(vec_bytes=vec, lanes=lanes,
                   chunks_per_lane=-(-chunks // lanes), threads=BWD_THREADS,
                   blocks=-(-items * lanes // BWD_THREADS), table_bytes=table,
                   map_bytes=values, l2_resident=table + values <= L2_BYTES)


def dtype_code(dtype) -> int:
    """The C entry points' dtype switch: 0 f32, 1 bf16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
