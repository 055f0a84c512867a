"""Sparse 3D convolution of the SECOND middle encoder: rulebook and conv.

Counterpart of ``unibev_tpu/ops/sparse_conv.py``.  The active voxels of one
resolution are a fixed-capacity row set (``SparseGrid``: coords (V, 4) int32
as (b, z, y, x), -1 on padding rows, and a mask).  A dense int32 table maps
each flat cell ``((b * D + z) * H + y) * W + x`` to its row, with the row
capacity V as the sentinel of an empty cell: the sentinel indexes the zero
row that a gather appends to the features.

* The rulebook, kernel K6 (``csrc/sparse_conv.cu::unibev_sparse_nbr``): for
  each output row and tap (dz, dy, dx), row-major with dx fastest, the input
  row at ``o * stride - padding + tap``, or the sentinel.  One function
  covers the JAX package's ``subm_neighbor_idx`` (stride 1, padding k // 2,
  output = input), ``strided_neighbor_idx`` and the (3, 1, 1) ``conv_out``
  table.
* The conv, kernel K7 (``csrc/sparse_conv.cu::unibev_sparse_conv``):
  ``out[v] = mask[v] ? sum_k feats[nidx[v, k]] @ W[k] : 0``, float32 sums,
  output in the features' dtype: what the JAX ``gather_conv`` and every
  x-pair / x-quad route of ``best_gather_conv`` compute, without writing the
  (V, K * Cin) columns.  The port drops those TPU gather-engine packings and
  the fp8 tables.
* The active set of a strided conv (``downsample_with_table``): the strided
  OR-pool of the input occupancy, its active cells in ascending flat order,
  the first ``capacity`` kept.  Which rows exist after a saturated downsample
  depends on that order, so it is exact, not approximate.

* The backward (``SparseConvFn``), the JAX package's scatter-free VJPs
  (``_subm_gc_bwd``, ``_strided_xp_bwd``): d_feats is K7 again, over the
  same rulebook with each tap transposed and the taps reversed for a
  submanifold conv, or over the inverse rulebook with each tap transposed
  for a strided one; d_weight is kernel K9.
* The inverse rulebook, kernel K8 (``csrc/sparse_conv.cu::
  unibev_sparse_inv_nbr``, the JAX ``inverse_strided_idx``): for each input
  row and tap, the output row of a strided conv that reads the row through
  the tap, or the output capacity (the sentinel, passed in).
* The weight gradient, kernel K9 (``csrc/sparse_conv.cu::
  unibev_sparse_conv_wgrad``, the JAX ``_dw_dot`` over the gathered
  columns): ``dW[k * Cin + c] = sum_v feats_pad[nidx[v, k], c] * g[v]``,
  float32 sums, float32 out; bf16 on the tensor cores over spans of rows,
  :func:`wgrad_plan` its launch plan.

CPU tensors take the plain versions (``sparse_nbr_reference``,
``sparse_conv_reference``, ``sparse_inv_nbr_reference``,
``sparse_conv_wgrad_reference``); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from unibev_tpu_torch.ops import _build

Triple = Tuple[int, int, int]


class SparseGrid(NamedTuple):
    """Active voxel set at one resolution (batch folded into the rows)."""
    coords: torch.Tensor   # (V, 4) int32 (b, z, y, x); -1 rows are padding
    mask: torch.Tensor     # (V,) bool
    shape: Triple          # (D, H, W)
    batch: int


def flat_index(coords: torch.Tensor, shape: Triple) -> torch.Tensor:
    """int64 flat cells ``((b * D + z) * H + y) * W + x`` of (V, 4) coords."""
    D, H, W = shape
    b, z, y, x = coords.to(torch.int64).unbind(1)
    return ((b * D + z) * H + y) * W + x


def build_table(grid: SparseGrid) -> torch.Tensor:
    """(B * D * H * W,) int32 row of each cell; V (the sentinel) where empty."""
    D, H, W = grid.shape
    V = grid.coords.shape[0]
    size = grid.batch * D * H * W
    table = torch.full((size + 1,), V, dtype=torch.int32,
                       device=grid.coords.device)
    flat = torch.where(grid.mask, flat_index(grid.coords, grid.shape), size)
    rows = torch.arange(V, dtype=torch.int32, device=table.device)
    # padding rows all write the trash cell at the end, which is dropped
    table.index_copy_(0, flat, rows)
    return table[:size]


def _tap_offsets(kernel: Triple, device) -> torch.Tensor:
    """(K, 3) (dz, dy, dx) taps, row-major, dx fastest."""
    kz, ky, kx = kernel
    taps = [(dz, dy, dx) for dz in range(kz) for dy in range(ky)
            for dx in range(kx)]
    return torch.tensor(taps, dtype=torch.int64, device=device)


def sparse_nbr_reference(table: torch.Tensor, sentinel: int, in_shape: Triple,
                         coords_out: torch.Tensor, mask_out: torch.Tensor,
                         kernel: Triple, stride: Triple,
                         padding: Triple) -> torch.Tensor:
    """Plain version of K6: (Vout, K) int32 input rows, ``sentinel`` where
    the tap falls outside the grid, on an empty cell, or the output row is
    masked."""
    D, H, W = in_shape
    offs = _tap_offsets(kernel, coords_out.device)                # (K, 3)
    c = coords_out.to(torch.int64)
    z = c[:, 1:2] * stride[0] - padding[0] + offs[:, 0]
    y = c[:, 2:3] * stride[1] - padding[1] + offs[:, 1]
    x = c[:, 3:4] * stride[2] - padding[2] + offs[:, 2]
    ok = (mask_out[:, None] & (z >= 0) & (z < D) & (y >= 0) & (y < H)
          & (x >= 0) & (x < W))
    flat = torch.where(ok, ((c[:, 0:1] * D + z) * H + y) * W + x, 0)
    return torch.where(ok, table[flat], sentinel).to(torch.int32)


def sparse_nbr(table: torch.Tensor, sentinel: int, in_shape: Triple,
               coords_out: torch.Tensor, mask_out: torch.Tensor,
               kernel: Triple, stride: Triple, padding: Triple) -> torch.Tensor:
    """The rulebook of one conv; CPU tensors take the plain version, CUDA
    tensors kernel K6.  Arguments as :func:`sparse_nbr_reference`; on CUDA
    the table and coords are int32, the mask bool, all contiguous."""
    if table.device.type == "cpu":
        return sparse_nbr_reference(table, sentinel, in_shape, coords_out,
                                    mask_out, kernel, stride, padding)
    tensors = (table, coords_out, mask_out)
    _on_current_cuda_device("sparse_nbr", tensors)
    Vout = coords_out.shape[0]
    if coords_out.shape != (Vout, 4) or mask_out.shape != (Vout,):
        raise ValueError(f"sparse_nbr: coords (V, 4) and mask (V,), got "
                         f"{tuple(coords_out.shape)} and {tuple(mask_out.shape)}")
    if table.dtype != torch.int32 or coords_out.dtype != torch.int32 \
            or mask_out.dtype != torch.bool:
        raise TypeError("sparse_nbr: table and coords int32, mask bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_nbr: the kernel takes contiguous tensors")
    K = kernel[0] * kernel[1] * kernel[2]
    out = torch.empty((Vout, K), dtype=torch.int32, device=table.device)
    err = _build.lib().unibev_sparse_nbr(
        table.data_ptr(), coords_out.data_ptr(), mask_out.data_ptr(),
        out.data_ptr(), Vout, *in_shape, *kernel, *stride, *padding, sentinel,
        table.numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sparse_nbr")
    _build.launches["sparse_nbr"] += 1
    return out


def subm_neighbor_idx(grid: SparseGrid, table: torch.Tensor,
                      kernel: Triple = (3, 3, 3)) -> torch.Tensor:
    """(V, K) rows of each active voxel's kernel-window neighbours."""
    pad = tuple(k // 2 for k in kernel)
    return sparse_nbr(table, grid.coords.shape[0], grid.shape, grid.coords,
                      grid.mask, kernel, (1, 1, 1), pad)


def strided_neighbor_idx(grid_in: SparseGrid, table_in: torch.Tensor,
                         coords_out: torch.Tensor, mask_out: torch.Tensor,
                         kernel: Triple, stride: Triple,
                         padding: Triple) -> torch.Tensor:
    """(Vout, K) input rows read by each output site of a strided conv."""
    return sparse_nbr(table_in, grid_in.coords.shape[0], grid_in.shape,
                      coords_out, mask_out, kernel, stride, padding)


def downsample_with_table(grid: SparseGrid, table: torch.Tensor,
                          kernel: Triple, stride: Triple, padding: Triple,
                          out_shape: Triple, capacity: int):
    """spconv's output sites of a strided conv: every site whose window
    covers an active input cell, in ascending flat order, the first
    ``capacity`` kept.

    Returns (coords_out (capacity, 4) int32, mask_out, table_out (the new
    resolution's table, sentinel ``capacity``), overflow (0-dim int64: sites
    beyond the capacity)).  No host synchronization.
    """
    D, H, W = grid.shape
    B = grid.batch
    occ = (table != grid.coords.shape[0]).view(B, 1, D, H, W)
    pooled = F.max_pool3d(occ.to(torch.float16), kernel, stride, padding)
    if tuple(pooled.shape[2:]) != tuple(out_shape):
        raise ValueError(f"pooled shape {tuple(pooled.shape[2:])} != {out_shape}")
    bitmap = pooled.view(-1) > 0
    rank = torch.cumsum(bitmap, 0) - 1
    kept = bitmap & (rank < capacity)
    dev = table.device
    slot = torch.where(kept, rank, capacity)
    cells = torch.arange(bitmap.numel(), dtype=torch.int64, device=dev)
    table_out = slot.to(torch.int32)
    flat = torch.zeros((capacity + 1,), dtype=torch.int64, device=dev)
    flat.scatter_(0, slot, cells)       # the trash slot takes the rest
    flat = flat[:capacity]
    total = rank[-1] + 1
    mask_out = torch.arange(capacity, device=dev) < total
    Do, Ho, Wo = out_shape
    coords = torch.stack([flat // (Do * Ho * Wo), (flat // (Ho * Wo)) % Do,
                          (flat // Wo) % Ho, flat % Wo], 1)
    coords = torch.where(mask_out[:, None], coords, -1).to(torch.int32)
    overflow = (total - capacity).clamp(min=0)
    return coords, mask_out, table_out, overflow


def sparse_conv_reference(feats: torch.Tensor, nidx: torch.Tensor,
                          weight: torch.Tensor,
                          out_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: gather the (Vout, K * Cin) columns from the
    zero-padded features, one product (float32 accumulation: cuBLAS sums
    bf16 products in float32), masked rows zero.

    feats (V, Cin); nidx (Vout, K) in [0, V], V the zero row; weight
    (K * Cin, Cout) tap-major; out_mask (Vout,) bool.
    """
    V, Cin = feats.shape
    Vout, K = nidx.shape
    padded = torch.cat([feats, feats.new_zeros((1, Cin))])
    cols = padded.index_select(0, nidx.reshape(-1).to(torch.int64))
    out = cols.view(Vout, K * Cin) @ weight.to(feats.dtype)
    return torch.where(out_mask[:, None], out, 0.0)


def gather_conv(feats: torch.Tensor, nidx: torch.Tensor, weight: torch.Tensor,
          out_mask: torch.Tensor) -> torch.Tensor:
    """One sparse conv without autograd (the JAX ``gather_conv``): CPU
    tensors take the plain version, CUDA tensors kernel K7.  Arguments as
    :func:`sparse_conv_reference`; on CUDA feats and weight share one dtype
    (float32 or bfloat16), nidx is int32, the mask bool, all contiguous."""
    if feats.device.type == "cpu":
        return sparse_conv_reference(feats, nidx, weight, out_mask)
    tensors = (feats, nidx, weight, out_mask)
    _on_current_cuda_device("sparse_conv", tensors)
    V, Cin = feats.shape
    Vout, K = nidx.shape
    if weight.dim() != 2 or weight.shape[0] != K * Cin or out_mask.shape != (Vout,):
        raise ValueError(f"sparse_conv: weight ({K * Cin}, Cout) and mask "
                         f"({Vout},), got {tuple(weight.shape)} and "
                         f"{tuple(out_mask.shape)}")
    code = _build.dtype_code(feats.dtype)
    if weight.dtype != feats.dtype:
        raise TypeError(f"sparse_conv: weight must be {feats.dtype}, got {weight.dtype}")
    if nidx.dtype != torch.int32 or out_mask.dtype != torch.bool:
        raise TypeError("sparse_conv: nidx int32, mask bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_conv: the kernel takes contiguous tensors")
    Cout = weight.shape[1]
    out = torch.empty((Vout, Cout), dtype=feats.dtype, device=feats.device)
    err = _build.lib().unibev_sparse_conv(
        feats.data_ptr(), nidx.data_ptr(), weight.data_ptr(),
        out_mask.data_ptr(), out.data_ptr(), Vout, K, Cin, Cout, V, code,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sparse_conv")
    _build.launches["sparse_conv"] += 1
    return out


def sparse_inv_nbr_reference(table_out: torch.Tensor, sentinel: int,
                             out_shape: Triple, coords_in: torch.Tensor,
                             mask_in: torch.Tensor, kernel: Triple,
                             stride: Triple, padding: Triple) -> torch.Tensor:
    """Plain version of K8: (Vin, K) int32 output rows of a strided conv.

    Input row i feeds output o through tap d iff ``o = (i + p - d) / s``
    exactly on every axis, o lies in ``out_shape``, and ``table_out`` (the
    output resolution's cell -> row table) holds a row in [0, sentinel)
    there; every other entry, and every tap of a masked input row, is
    ``sentinel`` (the output capacity: a site dropped by the capacity reads
    it, never a real row).  Taps (dz, dy, dx) row-major, dx fastest.
    """
    Do, Ho, Wo = out_shape
    offs = _tap_offsets(kernel, coords_in.device)                 # (K, 3)
    c = coords_in.to(torch.int64)
    q, ok = [], mask_in[:, None]
    for a, size in enumerate(out_shape):
        # shifted by k * s so the numerator stays non-negative
        v = c[:, a + 1:a + 2] + padding[a] + kernel[a] * stride[a] - offs[:, a]
        qa = torch.div(v, stride[a], rounding_mode="floor") - kernel[a]
        ok = ok & (v % stride[a] == 0) & (qa >= 0) & (qa < size)
        q.append(qa)
    flat = torch.where(ok, ((c[:, 0:1] * Do + q[0]) * Ho + q[1]) * Wo + q[2], 0)
    rows = table_out[flat]
    ok = ok & (rows >= 0) & (rows < sentinel)
    return torch.where(ok, rows, sentinel).to(torch.int32)


def sparse_inv_nbr(table_out: torch.Tensor, sentinel: int, out_shape: Triple,
                   coords_in: torch.Tensor, mask_in: torch.Tensor,
                   kernel: Triple, stride: Triple,
                   padding: Triple) -> torch.Tensor:
    """The inverse rulebook of a strided conv; CPU tensors take the plain
    version, CUDA tensors kernel K8.  Arguments as
    :func:`sparse_inv_nbr_reference`; on CUDA the table and coords are
    int32, the mask bool, all contiguous."""
    if table_out.device.type == "cpu":
        return sparse_inv_nbr_reference(table_out, sentinel, out_shape,
                                        coords_in, mask_in, kernel, stride,
                                        padding)
    tensors = (table_out, coords_in, mask_in)
    _on_current_cuda_device("sparse_inv_nbr", tensors)
    Vin = coords_in.shape[0]
    if coords_in.shape != (Vin, 4) or mask_in.shape != (Vin,):
        raise ValueError(f"sparse_inv_nbr: coords (V, 4) and mask (V,), got "
                         f"{tuple(coords_in.shape)} and {tuple(mask_in.shape)}")
    if table_out.dtype != torch.int32 or coords_in.dtype != torch.int32 \
            or mask_in.dtype != torch.bool:
        raise TypeError("sparse_inv_nbr: table and coords int32, mask bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_inv_nbr: the kernel takes contiguous tensors")
    K = kernel[0] * kernel[1] * kernel[2]
    out = torch.empty((Vin, K), dtype=torch.int32, device=table_out.device)
    err = _build.lib().unibev_sparse_inv_nbr(
        table_out.data_ptr(), coords_in.data_ptr(), mask_in.data_ptr(),
        out.data_ptr(), Vin, *out_shape, *kernel, *stride, *padding, sentinel,
        table_out.numel(), torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sparse_inv_nbr")
    _build.launches["sparse_inv_nbr"] += 1
    return out


def sparse_conv_wgrad_reference(feats: torch.Tensor, nidx: torch.Tensor,
                                g: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: the (K * Cin, Cout) float32 weight gradient
    ``cols^T @ g`` of the (Vout, K * Cin) columns gathered from the
    zero-padded features, float32 products and sums (the JAX ``_dw_dot``).

    feats (V, Cin); nidx (Vout, K) in [0, V], V the zero row; g (Vout, Cout).
    """
    V, Cin = feats.shape
    Vout, K = nidx.shape
    padded = torch.cat([feats, feats.new_zeros((1, Cin))])
    cols = padded.index_select(0, nidx.reshape(-1).to(torch.int64))
    return cols.view(Vout, K * Cin).float().t() @ g.float()


# K9's launch plan, the layout of csrc/sparse_conv.cu (WgradLayout,
# WgradWarps, wgrad_tile): 256 threads a block.
WGRAD_THREADS = 256
WGRAD_F32_ROWS = 64
# a (kc x bn) tile at least this large is wide: its partial of a tap is 32
# to 64 KB of float32 reductions
WGRAD_WIDE_TILE = 64 * 128


class WgradPlan(NamedTuple):
    """How K9 covers one call: blocks of ``kc`` input by ``bn`` output
    channels (``grid`` = (spans, output tiles, input chunks)) over ``span``
    rows each, items of ``chunk`` rows, ``smem_bytes`` of dynamic shared
    memory; bf16: the 8 warps as ``warps`` = (WM, WN, WK) of ``tiles`` =
    (MT, NT) mma tiles."""
    kc: int
    bn: int
    warps: Tuple[int, int, int]
    tiles: Tuple[int, int]
    chunk: int
    span: int
    grid: Triple
    smem_bytes: int


def _wgrad_tile(c: int, widest: int) -> int:
    return next((t for t in (16, 32, 64) if c <= t and t < widest), widest)


def wgrad_warps(kc: int, bn: int):
    """((WM, WN, WK), (MT, NT)): the 8 warps of a (kc x bn) tile as WM x WN
    warps of MT m-tiles of 16 input channels by NT n-tiles of 8 output
    channels, and WK warps taking every WK-th 16-row step of an item."""
    wm = min(kc // 16, 4)
    wn = min(bn // 8, 8 // wm)
    return (wm, wn, 8 // (wm * wn)), (kc // 16 // wm, bn // 8 // wn)


def wgrad_smem_bytes(K: int, span: int, chunk: int, kc: int, bn: int) -> int:
    """The bf16 kernel's shared memory (``wgrad_layout``): the (span x K)
    index tile, a flag per (tap, chunk), the item list and its count, a flag
    per row, then 128-aligned the g slice (span x (bn + 8) bf16) and two
    stages of gathered rows (chunk x (kc + 8))."""
    pairs = span // chunk * K
    head = 4 * (span * K + pairs + pairs + 1 + span)
    return -(-head // 128) * 128 + 2 * span * (bn + 8) + 4 * chunk * (kc + 8)


@functools.lru_cache(maxsize=None)
def wgrad_plan(Vout: int, K: int, Cin: int, Cout: int, itemsize: int,
               sms: int) -> WgradPlan:
    """K9's launch plan for ``Vout`` rows of ``K`` taps, ``Cin`` -> ``Cout``
    channels, in bf16 (``itemsize`` 2) or float32 (4), on a card of ``sms``
    SMs (:func:`_build.sm_count`).

    bf16: tiles of Cin and Cout each padded to 16, 32, 64 or 128 (wider
    takes more blocks).  Items of 256 rows at 16 or 32 input channels, 128
    at 64 or 128; spans of 256 rows, so that several blocks share an SM;
    for a wide tile (``WGRAD_WIDE_TILE``) the least span of whole items
    that puts one block on each SM, since every block adds a partial of up
    to 64 KB per live tap.  Input rows that are not 16-byte multiples
    (conv_input's Cin = 5, plain loads): items of 64 rows, spans of 128.
    Each the fastest of the spans and items measured at the flagship's
    sites (PERF.md section 6).  The kernel refuses a layout that disagrees
    with its own.  Cached: the wrapper asks once a call.

    float32 (CUDA cores): 16, 32 or 64 channel tiles, spans of 64-row steps
    halved from 4096 (not below 256) until the grid of (span, tap, tiles)
    blocks reaches 1024.
    """
    if itemsize == 4:
        kc, bn = _wgrad_tile(Cin, 64), _wgrad_tile(Cout, 64)
        tiles = -(-Cin // kc) * -(-Cout // bn)
        s = 4096
        while s > 256 and -(-Vout // s) * K * tiles < 1024:
            s //= 2
        return WgradPlan(kc=kc, bn=bn, warps=(0, 0, 0), tiles=(0, 0),
                         chunk=WGRAD_F32_ROWS, span=s,
                         grid=(-(-Vout // s), K, tiles), smem_bytes=0)
    kc, bn = _wgrad_tile(Cin, 128), _wgrad_tile(Cout, 128)
    warps, tiles = wgrad_warps(kc, bn)
    plain = Cin * itemsize % 16 != 0
    chunk = 64 if plain else 256 if kc <= 32 else 128
    span = 2 * chunk if plain else max(chunk, 256)
    if kc * bn >= WGRAD_WIDE_TILE:
        span = max(chunk, -(-Vout // (sms * chunk)) * chunk)
        while (span > chunk and wgrad_smem_bytes(K, span, chunk, kc, bn)
               > _build.MAX_SMEM_BYTES):
            span -= chunk
    return WgradPlan(kc=kc, bn=bn, warps=warps, tiles=tiles, chunk=chunk,
                     span=span,
                     grid=(-(-Vout // span), -(-Cout // bn), -(-Cin // kc)),
                     smem_bytes=wgrad_smem_bytes(K, span, chunk, kc, bn))


def sparse_conv_wgrad(feats: torch.Tensor, nidx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of a sparse conv; CPU tensors take the plain
    version, CUDA tensors kernel K9.  Arguments as
    :func:`sparse_conv_wgrad_reference`; on CUDA feats and g share one dtype
    (float32 or bfloat16), nidx is int32, all contiguous.  On the card the
    row spans are summed with float32 atomics, in no fixed order; the launch
    plan is :func:`wgrad_plan`."""
    if feats.device.type == "cpu":
        return sparse_conv_wgrad_reference(feats, nidx, g)
    tensors = (feats, nidx, g)
    _on_current_cuda_device("sparse_conv_wgrad", tensors)
    V, Cin = feats.shape
    Vout, K = nidx.shape
    if g.dim() != 2 or g.shape[0] != Vout:
        raise ValueError(f"sparse_conv_wgrad: g ({Vout}, Cout), got "
                         f"{tuple(g.shape)}")
    code = _build.dtype_code(feats.dtype)
    if g.dtype != feats.dtype:
        raise TypeError(f"sparse_conv_wgrad: g must be {feats.dtype}, got {g.dtype}")
    if nidx.dtype != torch.int32:
        raise TypeError("sparse_conv_wgrad: nidx int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("sparse_conv_wgrad: the kernel takes contiguous tensors")
    Cout = g.shape[1]
    plan = wgrad_plan(Vout, K, Cin, Cout, feats.element_size(),
                      _build.sm_count(feats.device.index))
    dw = torch.zeros((K * Cin, Cout), dtype=torch.float32, device=feats.device)
    err = _build.lib().unibev_sparse_conv_wgrad(
        feats.data_ptr(), nidx.data_ptr(), g.data_ptr(), dw.data_ptr(), Vout,
        K, Cin, Cout, V, code, plan.kc, plan.bn, plan.span, plan.chunk,
        plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sparse_conv_wgrad")
    _build.launches["sparse_conv_wgrad"] += 1
    return dw


def tap_transpose(weight: torch.Tensor, K: int, mirror: bool) -> torch.Tensor:
    """(K * Cin, Cout) tap-major -> (K * Cout, Cin): each tap transposed,
    the taps reversed when ``mirror`` (the JAX ``_mirror_transpose_weight``).
    Reversing the flat tap index is the point reflection of the window only
    because the window is odd and symmetric (3 x 3 x 3)."""
    w = weight.reshape(K, -1, weight.shape[1])
    if mirror:
        w = w.flip(0)
    return w.transpose(1, 2).reshape(-1, w.shape[1])


class SparseConvFn(torch.autograd.Function):
    """A sparse conv with the JAX package's gather-only backward.

    Forward: K7 (the plain version on the CPU), the weight cast to the
    features' dtype here, so float32 parameters run under bf16 autocast.
    Backward, with the cotangent g masked by ``out_mask`` and cast to the
    features' dtype:

    * submanifold (``inv_idx`` None; the input and output rows are one set):
      d_feats = K7(g, nidx, taps reversed and transposed, out_mask), since
      "j is tap k's neighbour of i" iff "i is tap K-1-k's neighbour of j";
    * strided: d_feats = K7(g, inv_idx, each tap transposed, all rows), over
      the inverse rulebook K8 of the output rows;
    * d_weight = K9(feats, nidx, g), cast to the weight's dtype.

    d_feats is skipped when the features need no gradient (the voxel
    features of ``conv_input``).
    """

    @staticmethod
    def forward(ctx, feats, nidx, weight, out_mask, inv_idx=None):
        ctx.save_for_backward(feats, nidx, weight, out_mask, inv_idx)
        return gather_conv(feats, nidx, weight.to(feats.dtype), out_mask)

    @staticmethod
    def backward(ctx, g):
        feats, nidx, weight, out_mask, inv_idx = ctx.saved_tensors
        g = torch.where(out_mask[:, None], g, 0.0).to(feats.dtype).contiguous()
        K = nidx.shape[1]
        d_feats = d_weight = None
        if ctx.needs_input_grad[0]:
            w = weight.to(feats.dtype)
            if inv_idx is None:
                d_feats = gather_conv(g, nidx, tap_transpose(w, K, True),
                                      out_mask)
            else:
                rows = torch.ones(feats.shape[0], dtype=torch.bool,
                                  device=feats.device)
                d_feats = gather_conv(g, inv_idx, tap_transpose(w, K, False),
                                      rows)
        if ctx.needs_input_grad[2]:
            d_weight = sparse_conv_wgrad(feats, nidx, g).to(weight.dtype)
        return d_feats, None, d_weight, None, None


def sparse_conv(feats: torch.Tensor, nidx: torch.Tensor, weight: torch.Tensor,
                out_mask: torch.Tensor,
                inv_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Sparse conv over a rulebook, differentiable (:class:`SparseConvFn`):
    CPU tensors take the plain versions, CUDA tensors kernels K7 and, in the
    backward, K7 and K9.  Arguments as :func:`sparse_conv_reference`, the
    weight in any float dtype (it is cast to the features'); ``inv_idx`` the
    inverse rulebook of a strided conv (:func:`sparse_inv_nbr`), needed for
    its d_feats, None for a submanifold conv."""
    return SparseConvFn.apply(feats, nidx, weight, out_mask, inv_idx)


def to_dense(feats: torch.Tensor, grid: SparseGrid) -> torch.Tensor:
    """Scatter the active rows into a dense (B, D, H, W, C) tensor."""
    D, H, W = grid.shape
    C = feats.shape[1]
    size = grid.batch * D * H * W
    flat = torch.where(grid.mask, flat_index(grid.coords, grid.shape), size)
    dense = feats.new_zeros((size + 1, C))
    # padding rows all write the trash row at the end, which is dropped
    dense.index_copy_(0, flat, torch.where(grid.mask[:, None], feats, 0.0))
    return dense[:size].view(grid.batch, D, H, W, C)


def _on_current_cuda_device(name, tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one CUDA device")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors are not on the current device")
