"""Linear sum assignment on the device (rectangular Jonker-Volgenant).

Counterpart of ``unibev_tpu/core/bbox/lsa.py``: the shortest augmenting
path algorithm that solves the head's Hungarian matching without a copy to
the host, so that the train step's assignment does not wait for the card.
Rows are gt boxes, columns queries; each valid row is assigned, in
increasing row order, by a Dijkstra over the columns from that row (reduced
costs against the duals ``u`` / ``v``), the duals' update and an augmenting
walk back along the tree.  With far fewer rows than columns each Dijkstra
ends almost at once, while most columns are free.

Two versions of one function: :func:`linear_sum_assignment_plain`, the
JAX loop written out in PyTorch (its arithmetic in JAX's order, ties to the
lowest column, as ``jnp.argmin`` and ``torch.argmin`` break them), and
kernel K12 (``csrc/lsa.cu``), which :func:`linear_sum_assignment` launches
for CUDA tensors: one block per problem, the mask read once into a list
of the valid rows, each valid row's costs staged in shared memory before
its Dijkstra starts, one barrier a Dijkstra step, and a row whose first
argmin column is free matched at once (no dual pass, no walk).  Both give
the same ``col4row`` bit for bit.  For a packed mask (the valid rows first, as
the data path packs them) the result is the JAX function's with
``num_valid`` = the mask's count; for any other mask it is the solution of
the valid rows' sub-matrix.  Costs must be finite (the assigner maps NaN
and inf to +-1e4).
"""

from __future__ import annotations

from typing import Tuple

import torch

from unibev_tpu_torch.ops import _build
from unibev_tpu_torch.utils.timer import spanned

# the JAX package's INF: the distance of a column the Dijkstra has not reached
INF = 1e30
# the most columns K12 takes (kMaxCols of csrc/lsa.cu)
MAX_COLS = 2048


def _solve(cost: torch.Tensor, valid: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """One (R, C) float32 problem: (col4row (R,) int32, its Dijkstra
    steps).  Reads the mask and the loop's indices on the host."""
    R, C = cost.shape
    dev = cost.device
    inf = torch.tensor(INF, dtype=torch.float32, device=dev)
    u = torch.zeros(R, dtype=torch.float32, device=dev)
    v = torch.zeros(C, dtype=torch.float32, device=dev)
    col4row = torch.full((R,), -1, dtype=torch.long, device=dev)
    row4col = torch.full((C,), -1, dtype=torch.long, device=dev)
    steps = 0
    for cur in torch.nonzero(valid).flatten().tolist():
        # Dijkstra over the columns from row cur
        shortest = torch.full((C,), INF, dtype=torch.float32, device=dev)
        path = torch.full((C,), -1, dtype=torch.long, device=dev)
        sr = torch.zeros(R, dtype=torch.bool, device=dev)
        remaining = torch.ones(C, dtype=torch.bool, device=dev)
        i, min_val = cur, torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(C):
            steps += 1
            sr[i] = True
            reduced = min_val + cost[i] - u[i] - v
            better = remaining & (reduced < shortest)
            shortest = torch.where(better, reduced, shortest)
            path = torch.where(better, i, path)
            masked = torch.where(remaining, shortest, inf)
            j = int(torch.argmin(masked))
            min_val = masked[j]
            remaining[j] = False
            nxt = int(row4col[j])
            if nxt < 0:
                break
            i = nxt
        else:
            raise ValueError("linear_sum_assignment: no free column reached; "
                             "the costs must be finite")
        # dual updates
        assigned = col4row >= 0
        col_of_row = torch.where(assigned, col4row, 0)
        delta_u = torch.where(
            sr, min_val - torch.where(assigned, shortest[col_of_row], 0.0), 0.0)
        delta_u[cur] = min_val
        u = u + delta_u
        v = v - torch.where(~remaining, min_val - shortest, 0.0)
        # augment along the alternating path
        while True:
            i = int(path[j])
            row4col[j] = i
            prev = int(col4row[i])
            col4row[i] = j
            if i == cur:
                break
            j = prev
    return col4row.int(), steps


def solve_with_steps(cost: torch.Tensor, valid: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version with each problem's count of Dijkstra steps, the
    length of the sequential chain K12 runs for it: (col4row (P, R) int32
    on cost's device, steps (P,) int64 on the CPU)."""
    P, R, C = cost.shape
    if R > C:
        raise ValueError(f"linear_sum_assignment: needs rows <= columns, got "
                         f"{tuple(cost.shape)}")
    col4row = torch.full((P, R), -1, dtype=torch.int32, device=cost.device)
    steps = torch.zeros(P, dtype=torch.long)
    for p in range(P):
        col4row[p], steps[p] = _solve(cost[p].float(), valid[p].bool())
    return col4row, steps


def linear_sum_assignment_plain(cost: torch.Tensor,
                                valid: torch.Tensor) -> torch.Tensor:
    """Plain version: the JAX loop per problem.

    cost (P, R, C) float32, R <= C (rows gt boxes, columns queries); valid
    (P, R) bool.  Returns col4row (P, R) int32, each valid row's column and
    -1 on the others.
    """
    return solve_with_steps(cost, valid)[0]


def linear_sum_assignment(cost: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Min-cost assignment of each problem's valid rows to distinct columns;
    CPU tensors take the plain version, CUDA tensors kernel K12, on the
    current stream, with nothing read back to the host.  Same arguments as
    :func:`linear_sum_assignment_plain`; on CUDA the kernel takes cost
    float32 and valid bool, both contiguous, and at most ``MAX_COLS``
    columns: anything else raises."""
    if cost.device.type == "cpu":
        return linear_sum_assignment_plain(cost, valid)
    return _lsa_cuda(cost, valid)


@spanned("kernel:lsa")
def _lsa_cuda(cost, valid):
    if cost.dim() != 3 or valid.shape != cost.shape[:2]:
        raise ValueError(f"linear_sum_assignment: cost (P, R, C) and valid "
                         f"(P, R), got {tuple(cost.shape)} and "
                         f"{tuple(valid.shape)}")
    P, R, C = cost.shape
    if R > C or C > MAX_COLS:
        raise ValueError(f"linear_sum_assignment: the kernel takes rows <= "
                         f"columns <= {MAX_COLS}, got {tuple(cost.shape)}")
    if valid.device != cost.device:
        raise ValueError("linear_sum_assignment: cost and valid must be on "
                         "one CUDA device")
    if cost.device.index != torch.cuda.current_device():
        raise ValueError("linear_sum_assignment: tensors are not on the "
                         "current device")
    if cost.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"linear_sum_assignment: cost float32 and valid bool, "
                        f"got {cost.dtype} and {valid.dtype}")
    if not (cost.is_contiguous() and valid.is_contiguous()):
        raise ValueError("linear_sum_assignment: the kernel takes contiguous "
                         "tensors")
    out = torch.empty((P, R), dtype=torch.int32, device=cost.device)
    if P == 0 or R == 0:
        return out
    err = _build.lib().unibev_lsa(
        cost.data_ptr(), valid.data_ptr(), out.data_ptr(), P, R, C,
        torch.cuda.current_stream().cuda_stream)
    _build.check(err, "linear_sum_assignment")
    _build.launches["lsa"] += 1
    return out
