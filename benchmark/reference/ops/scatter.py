"""Row scatter-add: kernel wrapper and plain version.

Counterpart of the Pallas TPU kernel ``unibev_tpu/ops/scatter_pallas.py::
scatter_add_rows``: ``rows[idx[m]] += contrib[m]`` into a fresh (tr, L)
table.  On the TPU every deformable-sampling backward ends in it (the MSDA
d_value, the DCNv2 d_x); the port's backward kernels K3 and K4 add their
rows straight into their tables with the same vector reductions
(``csrc/scatter.cuh``).  The radar branch's pillar scatter
(``models/radar.py::PointPillarsScatter``) runs it, its masked pillars at
index ``tr``, which both versions skip.  On CUDA it runs kernel K5
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


def scatter_add_rows_reference(idx: torch.Tensor, contrib: torch.Tensor,
                               tr: int,
                               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: a float32 ``index_add_``.

    idx (M,) integer; contrib (M, L).  Adds the rows whose index lies in
    [0, tr) into ``out`` (tr, L) float32 when given, else into a fresh zero
    table, and skips the others, as K5 does (``index_add_`` refuses them);
    returns the table.
    """
    if out is None:
        out = torch.zeros((tr, contrib.shape[1]), dtype=torch.float32,
                          device=contrib.device)
    # a skipped row adds 0 to row 0: no host sync, no data-dependent shape
    keep = (idx >= 0) & (idx < tr)
    return out.index_add_(0, torch.where(keep, idx.long(), 0),
                          torch.where(keep[:, None], contrib.float(), 0.0))


def scatter_add_rows(idx: torch.Tensor, contrib: torch.Tensor, tr: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``table[idx[m]] += contrib[m]``; CPU tensors take the plain version,
    CUDA tensors kernel K5.  Same arguments as
    :func:`scatter_add_rows_reference`.  On CUDA the kernel takes idx int32
    and contrib float32 or bfloat16, both contiguous; anything else raises.
    """
    return scatter_add_rows_reference(idx, contrib, tr, out)


