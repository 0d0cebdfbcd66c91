"""Launch orders of K1's and K2's plan rows other than the plans' own, to
measure and test the choice of order.

The kernels (`nerfail_tpu_torch/csrc/segsum.cu`, `segsum_sq.cu`) walk a
plan's rows in the order of its `launch_rows` table, which
`build_batched_csr_plan` lists in plan-row order. Any permutation of that
table that keeps each view's rows inside the view's range gives K1 the
same bits, and K2 the same squares added in another order:

    morton_order(plan, width)   each view's rows by the Morton code of the
                                row's first pixel
    reordered(plan, order)      the plan with its launch_rows permuted
    stored_in_launch_order(p)   the plan's rows stored in the order of its
                                launch_rows, as the plain versions walk
                                them

At the main path's shapes on the H100 the Morton order measured slower
than plan-row order for the kept kernels (PERF.md, Findings), so the
plans keep plan-row order. `tests/test_torch_segsum_order.py` and the
launch-order tests of `tests/test_torch_gpu.py` hold that every order
gives K1 the same bits and K2 its sums within their bound. Imports no
JAX.
"""

import dataclasses

import torch

from nerfail_tpu_torch.ops.cuda.segsum_kernel import CsrPlan, launch_rows_of


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 x < 2²⁰ with its bits moved to the even positions."""
    x = (x | (x << 16)) & 0x0000FFFF0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0F
    x = (x | (x << 2)) & 0x3333333333333333
    return (x | (x << 1)) & 0x5555555555555555


def pixel_morton(local_pix: torch.Tensor, width: int) -> torch.Tensor:
    """Morton (Z-order) code of pixels given by their index y·W + x in a
    view of `width` columns: x in the even bits, y in the odd ones."""
    p = local_pix.to(torch.int64)
    return _spread_bits(p % width) | (_spread_bits(p // width) << 1)


def morton_order(plan: CsrPlan, width: int) -> torch.Tensor:
    """int32 [R]: each view's plan rows (its view_ptr range) sorted by the
    Morton code of the row's first (smallest) pixel within its view of
    `width` columns, ties in plan order."""
    R = plan.n_rows
    if R == 0:
        return torch.zeros(0, dtype=torch.int32, device=plan.device)
    first = plan.pix[plan.row_ptr[:-1].to(torch.int64)].to(torch.int64)
    view = torch.repeat_interleave(
        torch.arange(plan.n_views, device=plan.device),
        torch.diff(plan.view_ptr).to(torch.int64))
    n_pix_view = plan.n_pixels // plan.n_views
    key = (view << 42) | pixel_morton(first % n_pix_view, width)
    return torch.sort(key, stable=True)[1].to(torch.int32)


def reordered(plan: CsrPlan, order: torch.Tensor) -> CsrPlan:
    """The same plan, its kernels walking the rows in `order` (int [R], a
    permutation that keeps each view's rows inside its view_ptr range)."""
    lr = plan.launch_rows[order.to(plan.device, torch.int64)]
    return dataclasses.replace(plan, launch_rows=lr.contiguous())


def stored_in_launch_order(plan: CsrPlan) -> CsrPlan:
    """The same pairs with the plan rows stored in the order of the plan's
    launch_rows (each row's pairs kept in their order), listed again in
    plan-row order: the plan as the kernels walk it. Its rows are not
    ascending."""
    lr = plan.launch_rows.to(torch.int64)
    start, rows = lr[:, 0], lr[:, 2]
    counts = lr[:, 1] - start
    row_ptr = torch.zeros_like(plan.row_ptr)
    row_ptr[1:] = torch.cumsum(counts, 0)
    pair = (torch.repeat_interleave(start - row_ptr[:-1].to(torch.int64),
                                    counts)
            + torch.arange(plan.n_pairs, device=plan.device))
    rows = rows.to(torch.int32)
    return dataclasses.replace(
        plan, row_ptr=row_ptr, pix=plan.pix[pair], w=plan.w[pair], rows=rows,
        launch_rows=launch_rows_of(row_ptr, rows, plan.view_ptr))
