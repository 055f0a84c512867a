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

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.utils.timer import spanned

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


def _table_args(name: str, table, coords: torch.Tensor, mask: torch.Tensor):
    """Check a rulebook kernel's inputs on CUDA; the table's pointers."""
    tensors = (table.bits, table.base, table.rows, coords, mask)
    _on_current_cuda_device(name, tensors)
    V = coords.shape[0]
    if coords.shape != (V, 4) or mask.shape != (V,):
        raise ValueError(f"{name}: coords (V, 4) and mask (V,), got "
                         f"{tuple(coords.shape)} and {tuple(mask.shape)}")
    if table.bits.shape != (-(-table.size // 32),) \
            or table.base.shape != table.bits.shape:
        raise ValueError(f"{name}: the table's bits and counts must hold one "
                         f"word per 32 of its {table.size} cells")
    if any(t.dtype != torch.int32 for t in tensors[:4]) \
            or mask.dtype != torch.bool:
        raise TypeError(f"{name}: table and coords int32, mask bool")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return (table.bits.data_ptr(), table.base.data_ptr(),
            table.rows.data_ptr(), table.rows.numel())


@spanned("kernel:sparse_nbr")
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
    if coords_out.device.type == "cpu":
        return sparse_nbr_reference(table, sentinel, in_shape, coords_out,
                                    mask_out, kernel, stride, padding)
    ptrs = _table_args("sparse_nbr", table, coords_out, mask_out)
    Vout = coords_out.shape[0]
    K = kernel[0] * kernel[1] * kernel[2]
    out = torch.empty((Vout, K), dtype=torch.int32, device=coords_out.device)
    err = _build.lib().unibev_sparse_nbr(
        *ptrs, coords_out.data_ptr(), mask_out.data_ptr(), out.data_ptr(),
        Vout, *in_shape, *kernel, *stride, *padding, sentinel, table.size,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "sparse_nbr")
    _build.launches["sparse_nbr"] += 1
    return out


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


class ActiveSetPlan(NamedTuple):
    """How K11 covers one call (``csrc/active_set.cu`` reads it as int64s
    in this order and refuses one whose layout or launch sizes disagree
    with its own).  ``mode`` 0 builds the table of the rows on the (batch,
    D, H, W) grid (the output grid is the input's, kernel, stride and
    padding unused); 1 the active set of a strided conv on the (batch, Do,
    Ho, Wo) grid, ``capacity`` rows.  One workspace of ``work_words``
    int32 words holds the table and every output: the bitmap (``padded``
    words, whole scan tiles) at 0, the scan state (a 64-bit status word a
    tile, the ticket, the total) at ``state_offset``, the per-word base at
    ``base_offset``, the rank -> row map at ``rows_offset`` and, in mode 1,
    the coords, the overflow (int64) and the mask (bytes) at theirs, each
    16-byte aligned; the fill zeroes the first ``zero_vectors`` 16-byte
    vectors.  Marks OR a warp's bits per word first where ``aggregate``;
    the emit takes a warp per ``group`` words.  Launches: ``fill_blocks``,
    ``row_blocks`` (mark, build_rows), ``tiles`` (scan), ``emit_blocks``
    (mode 1)."""
    rows_in: int
    batch: int
    D: int
    H: int
    W: int
    mode: int
    kz: int
    ky: int
    kx: int
    sz: int
    sy: int
    sx: int
    pz: int
    py: int
    px: int
    Do: int
    Ho: int
    Wo: int
    capacity: int
    words: int
    padded: int
    tiles: int
    aggregate: int
    group: int
    state_offset: int
    base_offset: int
    rows_offset: int
    coords_offset: int
    overflow_offset: int
    mask_offset: int
    work_words: int
    zero_vectors: int
    fill_blocks: int
    row_blocks: int
    emit_blocks: int


def _round4(n: int) -> int:
    return -(-n // 4) * 4


@functools.lru_cache(maxsize=None)
def active_set_plan(V: int, batch: int, shape: Triple, mode: int,
                    kernel: Triple, stride: Triple, padding: Triple,
                    out_shape: Triple, capacity: int) -> ActiveSetPlan:
    """K11's plan for ``V`` rows on the (batch, *shape) grid: mode 0 the
    table (``out_shape`` must be ``shape``), mode 1 a strided conv's active
    set on ``out_shape`` (the first ``capacity`` sites).  Raises where the
    kernel does not reach."""
    name = ("build_table", "downsample_with_table")[mode]
    size = batch * out_shape[0] * out_shape[1] * out_shape[2]
    if mode == 1 and capacity < 1:
        raise ValueError(f"{name}: capacity must be at least 1, got {capacity}")
    if mode == 1 and any(-(-k // s) > 4 or k < 1 or s < 1 or p < 0 for
                         k, s, p in zip(kernel, stride, padding)):
        raise ValueError(f"{name}: at most 4 sites per axis may hold an "
                         f"input cell; got kernel {kernel}, stride {stride}")
    if max(size // 32, V, capacity) >= 2 ** 31:
        raise ValueError(f"{name}: the kernel's int32 words, rows and ranks "
                         f"take fewer than 2^31 of each")
    words, padded = _build.bitmap_words(size)
    tiles = padded // _build.BITMAP_TILE_WORDS
    state = padded
    base = state + _build.scan_state_words(tiles)
    rows = base + padded
    if mode == 0:
        end = rows + _round4(V)
        aggregate = group = emit_blocks = 0
        coords = overflow = mask = end
    else:
        candidates = 1
        for k, s in zip(kernel, stride):
            candidates *= -(-k // s)
        aggregate = int(V * candidates > 4 * words)
        # 32 rows a warp where the ranks below the capacity come from words
        # at the density capacity / words gives, when they are full
        group = 32
        while group > 1 and group * capacity > 32 * words:
            group //= 2
        coords = rows + _round4(capacity)
        overflow = coords + 4 * capacity
        mask = overflow + 4
        end = mask + _round4(-(-capacity // 4))
        emit_blocks = _build.bitmap_blocks(max(-(-words // group) * 32,
                                               capacity))
    return ActiveSetPlan(
        rows_in=V, batch=batch, D=shape[0], H=shape[1], W=shape[2],
        mode=mode, kz=kernel[0], ky=kernel[1], kx=kernel[2], sz=stride[0],
        sy=stride[1], sx=stride[2], pz=padding[0], py=padding[1],
        px=padding[2], Do=out_shape[0], Ho=out_shape[1], Wo=out_shape[2],
        capacity=capacity, words=words, padded=padded, tiles=tiles,
        aggregate=aggregate, group=group, state_offset=state,
        base_offset=base, rows_offset=rows, coords_offset=coords,
        overflow_offset=overflow, mask_offset=mask, work_words=end,
        zero_vectors=base // 4,
        fill_blocks=_build.bitmap_blocks(base // 4, fill=True),
        row_blocks=_build.bitmap_blocks(V), emit_blocks=emit_blocks)


@spanned("kernel:active_set")
def _active_set(grid: SparseGrid, plan: ActiveSetPlan):
    """One launch of K11 by ``plan`` (the C entry point checks it): the
    table, and in mode 1 (coords_out, mask_out, overflow), all views of one
    workspace (``_table_views``)."""
    dev = grid.coords.device
    work = torch.empty((plan.work_words,), dtype=torch.int32, device=dev)
    err = _build.lib().unibev_active_set(
        grid.coords.data_ptr(), grid.mask.data_ptr(), work.data_ptr(),
        _build.plan_args(plan), len(plan),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, ("build_table", "downsample_with_table")[plan.mode])
    _build.launches["active_set"] += 1
    return _table_views(work, plan)


def _table_views(work: torch.Tensor, plan: ActiveSetPlan):
    """The table, and in mode 1 (coords_out, mask_out, overflow), as strided
    views of the workspace ``work`` at the plan's offsets."""
    words, n_rows = plan.words, plan.capacity if plan.mode else plan.rows_in
    table = CompactTable(
        work.as_strided((words,), (1,)),
        work.as_strided((words,), (1,), plan.base_offset),
        work.as_strided((n_rows,), (1,), plan.rows_offset),
        plan.batch * plan.Do * plan.Ho * plan.Wo, n_rows)
    if plan.mode == 0:
        return table, None, None, None
    cap = plan.capacity
    return (table, work.as_strided((cap, 4), (4, 1), plan.coords_offset),
            work.view(torch.bool).as_strided((cap,), (1,),
                                             4 * plan.mask_offset),
            work.view(torch.int64).as_strided((), (),
                                              plan.overflow_offset // 2))


def _table_plan(grid: SparseGrid, mode: int, kernel: Triple, stride: Triple,
                padding: Triple, out_shape: Triple, capacity: int):
    """K11's plan for ``grid`` after the checks the kernel cannot make."""
    name = ("build_table", "downsample_with_table")[mode]
    coords, mask = grid.coords, grid.mask
    _on_current_cuda_device(name, (coords, mask))
    V = coords.shape[0]
    if coords.shape != (V, 4) or mask.shape != (V,):
        raise ValueError(f"{name}: coords (V, 4) and mask (V,), got "
                         f"{tuple(coords.shape)} and {tuple(mask.shape)}")
    if coords.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError(f"{name}: coords int32 and mask bool, got "
                        f"{coords.dtype} and {mask.dtype}")
    if not (coords.is_contiguous() and mask.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return active_set_plan(V, grid.batch, tuple(grid.shape), mode, kernel,
                           stride, padding, out_shape, capacity)


def build_table(grid: SparseGrid) -> CompactTable:
    """The compact table of an active set (sentinel V, the row capacity).
    CPU tensors take the plain version, CUDA tensors kernel K11: a bit per
    live row's cell, a scan of the words' counts, and each row written at
    its cell's rank; the map's entries past the live rows read V.  On CUDA
    the coords are int32, the mask bool, both contiguous."""
    if grid.coords.device.type == "cpu":
        return build_table_reference(grid)
    return _active_set(grid, _table_plan(grid, 0, (1, 1, 1), (1, 1, 1),
                                         (0, 0, 0), tuple(grid.shape), 0))[0]


def downsample_with_table(grid: SparseGrid, kernel: Triple, stride: Triple,
                          padding: Triple, out_shape: Triple, capacity: int):
    """The active set of a strided conv and its table, as
    :func:`downsample_with_table_reference` returns them: (coords_out
    (capacity, 4) int32, mask_out, table_out (sentinel ``capacity``),
    overflow (0-dim int64)).  CPU tensors take the plain version, CUDA
    tensors kernel K11: each live row sets the bits of its candidate sites,
    a scan of the words' counts ranks them, and a warp per group of words
    writes their sites' coords below the capacity."""
    if grid.coords.device.type == "cpu":
        return downsample_with_table_reference(grid, kernel, stride, padding,
                                               out_shape, capacity)
    table, coords, mask, overflow = _active_set(grid, _table_plan(
        grid, 1, tuple(kernel), tuple(stride), tuple(padding),
        tuple(out_shape), capacity))
    return coords, mask, table, overflow


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


@spanned("kernel:sparse_conv")
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


@spanned("kernel:sparse_inv_nbr")
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
    if coords_in.device.type == "cpu":
        return sparse_inv_nbr_reference(table_out, sentinel, out_shape,
                                        coords_in, mask_in, kernel, stride,
                                        padding)
    ptrs = _table_args("sparse_inv_nbr", table_out, coords_in, mask_in)
    Vin = coords_in.shape[0]
    K = kernel[0] * kernel[1] * kernel[2]
    out = torch.empty((Vin, K), dtype=torch.int32, device=coords_in.device)
    err = _build.lib().unibev_sparse_inv_nbr(
        *ptrs, coords_in.data_ptr(), mask_in.data_ptr(), out.data_ptr(), Vin,
        *out_shape, *kernel, *stride, *padding, sentinel, table_out.size,
        torch.cuda.current_stream().cuda_stream)
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


@spanned("kernel:sparse_conv_wgrad")
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
