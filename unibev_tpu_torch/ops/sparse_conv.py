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

CPU tensors take the plain versions (``sparse_nbr_reference``,
``sparse_conv_reference``); CUDA tensors launch the kernels or raise.
Forward only: the backward (the JAX package's ``inverse_strided_idx`` and
the scatter-free VJPs) is not ported yet.
"""

from __future__ import annotations

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


def sparse_conv(feats: torch.Tensor, nidx: torch.Tensor, weight: torch.Tensor,
                out_mask: torch.Tensor) -> torch.Tensor:
    """Sparse conv over a rulebook; CPU tensors take the plain version, CUDA
    tensors kernel K7.  Arguments as :func:`sparse_conv_reference`; on CUDA
    feats and weight share one dtype (float32 or bfloat16), nidx is int32,
    the mask bool, all contiguous."""
    if feats.device.type == "cpu":
        return sparse_conv_reference(feats, nidx, weight, out_mask)
    tensors = (feats, nidx, weight, out_mask)
    _on_current_cuda_device("sparse_conv", tensors)
    if torch.is_grad_enabled() and (feats.requires_grad or weight.requires_grad):
        raise NotImplementedError("sparse_conv: the backward is not ported yet")
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
