"""Sparse 3D convolution of the SECOND middle encoder: rulebook and conv.

Counterpart of ``unibev_tpu/ops/sparse_conv.py``.  The active voxels of one
resolution are a fixed-capacity row set (``SparseGrid``: coords (V, 4) int32
as (b, z, y, x), -1 on padding rows, and a mask).  A compact table
(``CompactTable``: a bitmap over the flat cells ``((b * D + z) * H + y) * W
+ x``, per-word counts and a rank -> row map) maps each cell to its row,
with the row capacity V as the sentinel of an empty cell: the sentinel
indexes the zero row that a gather appends to the features.  The JAX
package keeps a dense int32 table; :func:`table_entries` decodes the
compact one to that view, for tests.

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
* The tables and active sets, kernel K11 (``csrc/active_set.cu::
  unibev_active_set``, one call a table): ``build_table``, the compact table
  of an active set, and ``downsample_with_table``, the active set of a
  strided conv: every output site whose window covers a live row, in
  ascending flat order, the first ``capacity`` kept, found from the rows'
  candidate sites (the JAX ``downsample_active_set``), never from a pass
  over the input grid, with its table.  Which rows exist after a saturated
  downsample depends on that order, so it is exact, not approximate.

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

CPU tensors take the plain versions (``build_table_reference``,
``downsample_with_table_reference``, ``sparse_nbr_reference``,
``sparse_conv_reference``, ``sparse_inv_nbr_reference``,
``sparse_conv_wgrad_reference``); CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch


Triple = Tuple[int, int, int]


class SparseGrid(NamedTuple):
    """Active voxel set at one resolution (batch folded into the rows)."""
    coords: torch.Tensor   # (V, 4) int32 (b, z, y, x); -1 rows are padding
    mask: torch.Tensor     # (V,) bool
    shape: Triple          # (D, H, W)
    batch: int


def flat_index(coords: torch.Tensor, shape: Triple) -> torch.Tensor:
    """int64 flat cells ``((b * D + z) * H + y) * W + x`` of (V, 4) coords."""
    steps = _grid_tables(tuple(shape), coords.device)[0]
    return (coords.to(torch.int64) * steps).sum(1)


class CompactTable(NamedTuple):
    """The cell -> row table of one resolution, compact (the counterpart of
    the JAX package's dense ``PackedTable``).

    Cell ``c`` (the flat index of :func:`flat_index`) is set iff bit ``c &
    31`` of ``bits[c >> 5]`` is; its rank, its place among the set cells in
    ascending flat order, is ``base[c >> 5] + popcount(bits[c >> 5] & ((1
    << (c & 31)) - 1))``, and its row ``rows[rank]``.  A cell that is not
    set, or whose rank is past the map (a site a downsample dropped for the
    capacity), reads ``sentinel``.  At the flagship's res 0 (B * 41 * 1440
    * 1440 cells) that is 21 MB in all, where a dense int32 table took 340
    MB: the whole table stays in the H100's 50 MB L2.
    """
    bits: torch.Tensor     # (words,) int32, words = ceil(size / 32)
    base: torch.Tensor     # (words,) int32: set bits in the words before
    rows: torch.Tensor     # (n,) int32: the row of each rank below n
    size: int              # cells, B * D * H * W
    sentinel: int          # the row capacity: what an empty cell reads


@functools.lru_cache(maxsize=None)
def _bit_tables(device: torch.device):
    """Constant tables: (32,) int32 ``1 << j`` (bit 31 as its
    two's-complement value); (8,) uint8 ``1 << j``; (256,) int32 set bits
    of a byte; (256, 8) int64 the place of each byte's k-th set bit (0 past
    its last)."""
    bit = [1 << j for j in range(31)] + [-2 ** 31]
    places = [[j for j in range(8) if v >> j & 1] for v in range(256)]
    return (torch.tensor(bit, dtype=torch.int32, device=device),
            torch.tensor([1 << j for j in range(8)], dtype=torch.uint8,
                         device=device),
            torch.tensor([len(p) for p in places], dtype=torch.int32,
                         device=device),
            torch.tensor([p + [0] * (8 - len(p)) for p in places],
                         device=device))


@functools.lru_cache(maxsize=None)
def _grid_tables(shape: Triple, device: torch.device):
    """The flat steps (4,) of (b, z, y, x) in a grid of ``shape``, and the
    moduli (4,) that recover them from a flat cell's quotients (b needs
    none)."""
    D, H, W = shape
    return (torch.tensor([D * H * W, H * W, W, 1], device=device),
            torch.tensor([2 ** 62, D, H, W], device=device))


def build_table_reference(grid: SparseGrid) -> CompactTable:
    """Plain version of K11's table: the compact table of an active set
    (sentinel V, the row capacity).  One sort of the live rows' flat cells
    gives the rank -> row map, and the bits and each word's count come from
    the rows; nothing passes over the grid's cells.  The live rows' cells
    are distinct, as the voxelizer gives them."""
    D, H, W = grid.shape
    V = grid.coords.shape[0]
    size = grid.batch * D * H * W
    words = -(-size // 32)
    dev = grid.coords.device
    bit = _bit_tables(dev)[0]
    flat = torch.where(grid.mask, flat_index(grid.coords, grid.shape),
                       32 * words)             # padding: past the words
    keys, order = torch.sort(flat)
    w = keys >> 5
    bits = torch.zeros((words + 1,), dtype=torch.int32, device=dev)
    bits.index_add_(0, w, bit[keys & 31])       # distinct bits: sums = ORs
    count = torch.zeros((words + 2,), dtype=torch.int32, device=dev)
    count.index_add_(0, w + 1, torch.ones_like(keys, dtype=torch.int32))
    return CompactTable(bits[:words], count[:words].cumsum(0, dtype=torch.int32),
                        order.to(torch.int32), size, V)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 holding a 32-bit value (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x * 0x01010101 >> 24) & 0xFF


def table_lookup(table: CompactTable, flat: torch.Tensor,
                 sentinel: int) -> torch.Tensor:
    """int64 rows of the cells ``flat`` (int64, each in [0, size)),
    ``sentinel`` where a cell is not set or its rank is past the map: the
    kernels' rank arithmetic."""
    w = flat >> 5
    word = table.bits[w].to(torch.int64) & 0xFFFFFFFF
    bit = flat & 31
    rank = table.base[w].to(torch.int64) + _popcount(word & ((1 << bit) - 1))
    hit = (((word >> bit) & 1) == 1) & (rank < table.rows.numel())
    rows = table.rows[torch.where(hit, rank, 0)].to(torch.int64)
    return torch.where(hit, rows, sentinel)


def table_entries(table: CompactTable) -> torch.Tensor:
    """The dense (size,) int32 view of a compact table, the JAX
    ``table_entries``: for tests only (it passes over every cell)."""
    flat = torch.arange(table.size, device=table.bits.device)
    return table_lookup(table, flat, table.sentinel).to(torch.int32)


def _tap_offsets(kernel: Triple, device) -> torch.Tensor:
    """(K, 3) (dz, dy, dx) taps, row-major, dx fastest."""
    kz, ky, kx = kernel
    taps = [(dz, dy, dx) for dz in range(kz) for dy in range(ky)
            for dx in range(kx)]
    return torch.tensor(taps, dtype=torch.int64, device=device)


def rulebook_cells(in_shape: Triple, coords_out: torch.Tensor,
                   mask_out: torch.Tensor, kernel: Triple, stride: Triple,
                   padding: Triple):
    """((Vout, K) int64 input cells that K6 looks up, (Vout, K) bool): the
    cell at ``o * stride - padding + tap`` and whether it lies in the grid
    and the output row is live (cell 0 where not)."""
    D, H, W = in_shape
    offs = _tap_offsets(kernel, coords_out.device)                # (K, 3)
    c = coords_out.to(torch.int64)
    z = c[:, 1:2] * stride[0] - padding[0] + offs[:, 0]
    y = c[:, 2:3] * stride[1] - padding[1] + offs[:, 1]
    x = c[:, 3:4] * stride[2] - padding[2] + offs[:, 2]
    ok = (mask_out[:, None] & (z >= 0) & (z < D) & (y >= 0) & (y < H)
          & (x >= 0) & (x < W))
    return torch.where(ok, ((c[:, 0:1] * D + z) * H + y) * W + x, 0), ok


def sparse_nbr_reference(table: CompactTable, sentinel: int,
                         in_shape: Triple, coords_out: torch.Tensor,
                         mask_out: torch.Tensor, kernel: Triple,
                         stride: Triple, padding: Triple) -> torch.Tensor:
    """Plain version of K6: (Vout, K) int32 input rows, ``sentinel`` where
    the tap falls outside the grid, on an empty cell, or the output row is
    masked."""
    flat, ok = rulebook_cells(in_shape, coords_out, mask_out, kernel, stride,
                              padding)
    rows = table_lookup(table, flat, sentinel)
    return torch.where(ok, rows, sentinel).to(torch.int32)


def sparse_nbr(table: CompactTable, sentinel: int, in_shape: Triple,
               coords_out: torch.Tensor, mask_out: torch.Tensor,
               kernel: Triple, stride: Triple, padding: Triple) -> torch.Tensor:
    """The rulebook of one conv; CPU tensors take the plain version, CUDA
    tensors kernel K6.  Arguments as :func:`sparse_nbr_reference`; on CUDA
    the table's tensors and the coords are int32, the mask bool, all
    contiguous."""
    if not isinstance(table, CompactTable):
        raise TypeError(f"sparse_nbr: the table must be a CompactTable, got "
                        f"{type(table).__name__}")
    return sparse_nbr_reference(table, sentinel, in_shape, coords_out,
                                mask_out, kernel, stride, padding)


def subm_neighbor_idx(grid: SparseGrid, table: CompactTable,
                      kernel: Triple = (3, 3, 3)) -> torch.Tensor:
    """(V, K) rows of each active voxel's kernel-window neighbours."""
    pad = tuple(k // 2 for k in kernel)
    return sparse_nbr(table, grid.coords.shape[0], grid.shape, grid.coords,
                      grid.mask, kernel, (1, 1, 1), pad)


def strided_neighbor_idx(grid_in: SparseGrid, table_in: CompactTable,
                         coords_out: torch.Tensor, mask_out: torch.Tensor,
                         kernel: Triple, stride: Triple,
                         padding: Triple) -> torch.Tensor:
    """(Vout, K) input rows read by each output site of a strided conv."""
    return sparse_nbr(table_in, grid_in.coords.shape[0], grid_in.shape,
                      coords_out, mask_out, kernel, stride, padding)


@functools.lru_cache(maxsize=None)
def _site_tables(in_shape: Triple, out_shape: Triple, batch: int,
                 kernel: Triple, stride: Triple, padding: Triple,
                 device: torch.device):
    """The output sites of a strided conv whose window holds an input cell,
    as tables of flat-index terms: (batch + 1,) ``b * Do * Ho * Wo`` with
    the trash cell last (a padding row's b = -1 reads it), and per axis a
    (ceil(k / s), size_in) table of ``o * step`` for each input coordinate,
    the trash cell where it has fewer sites.  The trash cell is the first
    past the output's 32-cell words, so any sum holding it lies past them."""
    Do, Ho, Wo = out_shape
    trash = -(-batch * Do * Ho * Wo // 32) * 32
    tables = [torch.tensor([b * Do * Ho * Wo for b in range(batch)] + [trash])]
    for size_in, size, k, s, p, step in zip(in_shape, out_shape, kernel,
                                            stride, padding,
                                            (Ho * Wo, Wo, 1)):
        i = torch.arange(size_in)
        # site o holds i in its window iff o * s - p <= i < o * s - p + k
        o = torch.div(i + p, s, rounding_mode="floor") \
            - torch.arange(-(-k // s))[:, None]
        ok = (o >= 0) & (o < size) & (o * s - p + k > i)
        tables.append(torch.where(ok, o * step, trash))
    return [t.to(device) for t in tables]


@functools.lru_cache(maxsize=None)
def _ranks(capacity: int, device: torch.device) -> torch.Tensor:
    """(capacity,) int32 0 .. capacity - 1: the ranks a downsample keeps and
    its table's rank -> row map (read only)."""
    return torch.arange(capacity, dtype=torch.int32, device=device)


def downsample_with_table_reference(grid: SparseGrid, kernel: Triple,
                                    stride: Triple, padding: Triple,
                                    out_shape: Triple, capacity: int):
    """Plain version of K11's active set: spconv's output sites of a strided
    conv, every site whose window covers an active input cell, in ascending
    flat order, the first ``capacity`` kept.  What the JAX
    ``downsample_with_table`` computes with an OR-pool of the dense
    occupancy, from the rows (its ``downsample_active_set``):

    * each live row names the at most ceil(k / s) sites per axis whose
      window holds it (8 candidates for k3 s2, 2 for (3, 1, 1) s(2, 1, 1)),
      read from small per-axis tables, and marks a byte per output cell;
    * the bytes give the bitmap's words and an inclusive count of set bits
      per byte of the bitmap;
    * rank r's site lies in the first byte whose count exceeds r (a search
      of the counts), at the place of that byte's (r - bits before it)-th
      set bit: the coords of the first ``capacity`` ranks;
    * the new table's bitmap holds every site and its rank -> row map the
      first ``capacity`` ranks (the rank is the row), so a dropped site
      reads the sentinel, as in the dense table.

    Nothing passes over the input grid's cells; the output grid is passed
    over as bytes (marking, packing) and as bytes of the bitmap (counts).

    Returns (coords_out (capacity, 4) int32, mask_out, table_out (the new
    resolution's :class:`CompactTable`, sentinel ``capacity``), overflow
    (0-dim int64: sites beyond the capacity)).  No host synchronization.
    """
    size = grid.batch * out_shape[0] * out_shape[1] * out_shape[2]
    words = -(-size // 32)
    trash = 32 * words
    dev = grid.coords.device
    tb, tz, ty, tx = _site_tables(tuple(grid.shape), tuple(out_shape),
                                  grid.batch, tuple(kernel), tuple(stride),
                                  tuple(padding), dev)
    steps, mods = _grid_tables(tuple(out_shape), dev)
    _, pow2, pop8, place8 = _bit_tables(dev)
    ranks = _ranks(capacity, dev)
    c = torch.where(grid.mask[:, None], grid.coords, -1)
    flat = (tb[c[:, 0]][:, None, None, None]
            + tz[:, c[:, 1]].t()[:, :, None, None]
            + ty[:, c[:, 2]].t()[:, None, :, None]
            + tx[:, c[:, 3]].t()[:, None, None, :])
    occ = torch.zeros((trash + 32,), dtype=torch.uint8, device=dev)
    occ.index_put_((flat.clamp(max=trash),), pow2[0])     # a 1 on the card
    packed = (occ[:trash].view(-1, 8) * pow2).sum(1, dtype=torch.uint8)
    byte_bits = packed.to(torch.int32)
    count = pop8[byte_bits]
    seen = count.cumsum(0, dtype=torch.int32)  # set bits up to each byte
    before = seen - count
    total = seen[-1]
    byte = torch.searchsorted(seen, ranks, right=True).clamp(max=4 * words - 1)
    k = (ranks - before[byte]).clamp(0, 7)
    cells = byte * 8 + place8[byte_bits[byte], k]
    mask_out = ranks < total
    coords = (cells[:, None] // steps) % mods
    coords = torch.where(mask_out[:, None], coords, -1).to(torch.int32)
    table = CompactTable(packed.view(torch.int32), before[::4].contiguous(),
                         ranks, size, capacity)
    return coords, mask_out, table, (total - capacity).clamp(min=0).long()


def build_table(grid: SparseGrid) -> CompactTable:
    """The compact table of an active set (sentinel V, the row capacity).
    CPU tensors take the plain version, CUDA tensors kernel K11: a bit per
    live row's cell, a scan of the words' counts, and each row written at
    its cell's rank; the map's entries past the live rows read V.  On CUDA
    the coords are int32, the mask bool, both contiguous."""
    return build_table_reference(grid)


def downsample_with_table(grid: SparseGrid, kernel: Triple, stride: Triple,
                          padding: Triple, out_shape: Triple, capacity: int):
    """The active set of a strided conv and its table, as
    :func:`downsample_with_table_reference` returns them: (coords_out
    (capacity, 4) int32, mask_out, table_out (sentinel ``capacity``),
    overflow (0-dim int64)).  CPU tensors take the plain version, CUDA
    tensors kernel K11: each live row sets the bits of its candidate sites,
    a scan of the words' counts ranks them, and a warp per group of words
    writes their sites' coords below the capacity."""
    return downsample_with_table_reference(grid, kernel, stride, padding,
                                           out_shape, capacity)


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
    return sparse_conv_reference(feats, nidx, weight, out_mask)


def inverse_cells(out_shape: Triple, coords_in: torch.Tensor,
                  mask_in: torch.Tensor, kernel: Triple, stride: Triple,
                  padding: Triple):
    """((Vin, K) int64 output cells that K8 looks up, (Vin, K) bool): the
    cell ``o = (i + p - d) / s`` of input row i and tap d, and whether the
    division is exact on every axis, o lies in ``out_shape`` and the row is
    live (cell 0 where not)."""
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
    flat = ((c[:, 0:1] * Do + q[0]) * Ho + q[1]) * Wo + q[2]
    return torch.where(ok, flat, 0), ok


def sparse_inv_nbr_reference(table_out: CompactTable, sentinel: int,
                             out_shape: Triple, coords_in: torch.Tensor,
                             mask_in: torch.Tensor, kernel: Triple,
                             stride: Triple, padding: Triple) -> torch.Tensor:
    """Plain version of K8: (Vin, K) int32 output rows of a strided conv.

    Input row i feeds output o through tap d iff ``o = (i + p - d) / s``
    exactly on every axis, o lies in ``out_shape``, and ``table_out`` (the
    output resolution's table) holds a row in [0, sentinel) there; every
    other entry, and every tap of a masked input row, is ``sentinel`` (the
    output capacity: a site dropped by the capacity is empty in the table,
    never a real row).  Taps (dz, dy, dx) row-major, dx fastest.
    """
    flat, ok = inverse_cells(out_shape, coords_in, mask_in, kernel, stride,
                             padding)
    rows = table_lookup(table_out, flat, sentinel)
    ok = ok & (rows >= 0) & (rows < sentinel)
    return torch.where(ok, rows, sentinel).to(torch.int32)


def sparse_inv_nbr(table_out: CompactTable, sentinel: int, out_shape: Triple,
                   coords_in: torch.Tensor, mask_in: torch.Tensor,
                   kernel: Triple, stride: Triple,
                   padding: Triple) -> torch.Tensor:
    """The inverse rulebook of a strided conv; CPU tensors take the plain
    version, CUDA tensors kernel K8.  Arguments as
    :func:`sparse_inv_nbr_reference`; on CUDA the table's tensors and the
    coords are int32, the mask bool, all contiguous."""
    if not isinstance(table_out, CompactTable):
        raise TypeError(f"sparse_inv_nbr: the table must be a CompactTable, "
                        f"got {type(table_out).__name__}")
    return sparse_inv_nbr_reference(table_out, sentinel, out_shape,
                                    coords_in, mask_in, kernel, stride,
                                    padding)


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


def sparse_conv_wgrad(feats: torch.Tensor, nidx: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """The weight gradient of a sparse conv; CPU tensors take the plain
    version, CUDA tensors kernel K9.  Arguments as
    :func:`sparse_conv_wgrad_reference`; on CUDA feats and g share one dtype
    (float32 or bfloat16), nidx is int32, all contiguous.  On the card the
    row spans are summed with float32 atomics, in no fixed order; the launch
    plan is :func:`wgrad_plan`."""
    return sparse_conv_wgrad_reference(feats, nidx, g)


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


