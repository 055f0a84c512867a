"""Row scatter-add: kernel wrapper and plain version.

Counterpart of the Pallas TPU kernel ``unibev_tpu/ops/scatter_pallas.py::
scatter_add_rows``: ``rows[idx[m]] += contrib[m]`` into a fresh (tr, L)
table.  On the TPU every deformable-sampling backward ends in it (the MSDA
d_value, the DCNv2 d_x); the port's backward kernels K3 and K4 add their
rows straight into their tables with the same vector reductions
(``csrc/scatter.cuh``), so no path launches it.  On CUDA it runs kernel K5
(``csrc/scatter.cu::unibev_scatter_add_rows``).

The table is float32 whatever the contributions' dtype, and a caller may run
several chunks of rows into one table through ``out`` before it rounds the
table once to its dtype.  The Pallas kernel sums bf16 contributions in bf16;
this is at least as accurate.  On the card the adds are atomics, so their
order, and the last bits of a sum, change from run to run.
"""

from __future__ import annotations

from typing import Optional

import torch

from unibev_tpu_torch.ops import _build


def scatter_add_rows_reference(idx: torch.Tensor, contrib: torch.Tensor,
                               tr: int,
                               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: a float32 ``index_add_``.

    idx (M,) integer in [0, tr); contrib (M, L).  Adds into ``out`` (tr, L)
    float32 when given, else into a fresh zero table; returns the table.
    """
    if out is None:
        out = torch.zeros((tr, contrib.shape[1]), dtype=torch.float32,
                          device=contrib.device)
    return out.index_add_(0, idx.long(), contrib.float())


def scatter_add_rows(idx: torch.Tensor, contrib: torch.Tensor, tr: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx[m]] += contrib[m]``; CPU tensors take the plain version,
    CUDA tensors kernel K5.  Same arguments as
    :func:`scatter_add_rows_reference`.  On CUDA the kernel takes idx int32
    and contrib float32 or bfloat16, both contiguous; anything else raises.
    """
    if contrib.device.type == "cpu":
        return scatter_add_rows_reference(idx, contrib, tr, out)
    return _scatter_cuda(idx, contrib, tr, out)


def _scatter_cuda(idx, contrib, tr, out):
    if contrib.dim() != 2 or idx.shape != contrib.shape[:1]:
        raise ValueError(f"scatter_add_rows: idx (M,) and contrib (M, L), got "
                         f"{tuple(idx.shape)} and {tuple(contrib.shape)}")
    M, L = contrib.shape
    if out is None:
        out = torch.zeros((tr, L), dtype=torch.float32, device=contrib.device)
    if out.shape != (tr, L) or out.dtype != torch.float32:
        raise ValueError(f"scatter_add_rows: out must be ({tr}, {L}) float32")
    tensors = (idx, contrib, out)
    if any(t.device != contrib.device for t in tensors):
        raise ValueError("scatter_add_rows: all tensors must be on one CUDA device")
    if contrib.device.index != torch.cuda.current_device():
        raise ValueError("scatter_add_rows: tensors are not on the current device")
    if idx.dtype != torch.int32:
        raise TypeError(f"scatter_add_rows: idx must be int32, got {idx.dtype}")
    code = _build.dtype_code(contrib.dtype)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("scatter_add_rows: the kernel takes contiguous tensors")
    err = _build.lib().unibev_scatter_add_rows(
        idx.data_ptr(), contrib.data_ptr(), out.data_ptr(), M, L, tr, code,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "scatter_add_rows")
    _build.launches["scatter_add_rows"] += 1
    return out
