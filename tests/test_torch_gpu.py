"""PyTorch port: the CUDA kernels against their plain versions, on a card.

Marked `gpu`; every test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs where only PyTorch is
installed:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: K1 within the fp32 summation bound of `error_bound` (both
sum the same rounded products in another order) and bit-identical across
runs, in any launch order, and reading a class of a stack in place or a
copy of it, and stopping on a class outside the stack; K2 within
`sq_error_bound` (K1's bound carried through the square and K2's fixed
reduction tree) and bit-identical across runs, in the launch order and in
plan-row order; K3 distances bit-equal to the plain version (same f32 arithmetic),
indices equal wherever the distance is not tied, and the split search +
merge bit-equal, ties included, to one item a row and to its planned
plain walk; the plan on the card equal to the plan on the CPU. K4/K5 (the fused NeRF
MLP; K4 also at every width class, depth 1, two skips, and tiles of 64,
192 and three waves plus half a tile) bit-identical across launches; layer 0's product within the f32
summation bound of its bf16 operands; the output and every gradient
within 2 % of the tensor's largest entry of the plain version (the same
bf16 operands summed in another order; an activation whose f32 value
differs in its last bit can round to a bf16 one ulp, 2⁻⁸, away, and that
difference travels through the later layers); d_pts by its relative L2
error, 2 % (the encoding jacobian sums 63 cancelling terms scaled by up
to 2⁹, so its largest entries are cancellation residues). Both 3D
attacks on the card against the same call on the CPU (the plain
kernels): NeRFail-S's clean accuracies and NeRFail's control plane
equal, NeRFail-S's δ equal on ≥ 99 % of its entries (a sign step turns
on sums in another order), NeRFail's within 1e-2 on the 0-255 scale. Launch counts are exact wherever the entry point
fixes them: K1 once a NeRFail-S step, K1 and K2 once a DeepFool
iteration, K4 twice a chunk of rays, K4 and K5 twice a train step.
"""

import contextlib
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerfail_tpu_torch.ops.cuda.knn_kernel import (
    KnnPrep, KnnQueryPlan, knn, knn_plain, knn_sq_cuda, knn_sq_plain,
    knn_sq_planned_plain,
)
from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
    build_batched_csr_plan, build_csr_plan, class_rows, error_bound,
    segment_sq, segment_sq_plain, segment_sum, segment_sum_class,
    segment_sum_plain, sq_error_bound,
)
from tools.segsum_order import (
    morton_order, reordered, stored_in_launch_order,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launches():
    """Every kernel wrapper's launch count: K1-K5."""
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward

    return {"K1": segment_sum.launches, "K2": segment_sq.launches,
            "K3": knn_sq_cuda.launches, "K4": mlp_forward.launches,
            "K5": mlp_backward.launches}


def _since(before):
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _launches().items()}


def _skewed_tables(seed, M, B=2, H=64, W=64, k=8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, M // 2, (B, H, W, k))           # half the points empty
    hot = rng.uniform(size=idx.shape) < 0.05
    idx[hot] = 7                                          # one very long segment
    w = rng.uniform(0, 1, (B, H, W, k)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W, 1)) > 0.3
    return (torch.from_numpy(idx.astype(np.int32)), torch.from_numpy(w),
            torch.from_numpy(mask))


@pytest.mark.parametrize("C", [1, 3, 4, 7, 16, 32])
def test_segsum_kernel_matches_plain(cuda, C):
    M = 3001
    idx, w, mask = _skewed_tables(C, M)
    plan = build_csr_plan(idx.to(cuda), w.to(cuda), M,
                          pair_mask=mask.to(cuda))
    g = torch.randn(idx[..., 0].numel(), C, generator=torch.Generator()
                    .manual_seed(C)).to(cuda)
    before = segment_sum.launches
    out = segment_sum(g, plan)
    again = segment_sum(g, plan)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    assert torch.equal(out, again)                      # deterministic
    ref = segment_sum_plain(g, plan)
    assert ((out - ref).abs() <= error_bound(g, plan)).all()
    empty = torch.ones(M, dtype=torch.bool, device=cuda)
    empty[plan.rows.long()] = False
    assert empty.any() and (out[empty] == 0).all()
    cpu = segment_sum(g.cpu(), plan.to("cpu"))
    torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=1e-4)


def test_segsum_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    M = 100
    idx, w, _ = _skewed_tables(0, M, B=1, H=4, W=4)
    plan = build_csr_plan(idx.to(cuda), w.to(cuda), M)
    g = torch.randn(16, 4, device=cuda)
    with pytest.raises(ValueError):
        segment_sum(g.double(), plan)
    with pytest.raises(ValueError):
        segment_sum(torch.randn(4, 16, device=cuda).T, plan)
    with pytest.raises(ValueError):
        segment_sum(torch.randn(16, 33, device=cuda), plan)
    with pytest.raises(ValueError):
        segment_sum(g, plan.to("cpu"))
    for name in ("row_ptr", "rows"):
        bad = dataclasses.replace(plan, **{name: getattr(plan, name).long()})
        with pytest.raises(ValueError):
            segment_sum(g, bad)


def _untied(d9: torch.Tensor) -> torch.Tensor:
    """[Q, 8] mask of neighbours whose distance differs from both of its
    neighbours in the sorted 9-NN list."""
    ok = torch.ones(d9.shape[0], 8, dtype=torch.bool, device=d9.device)
    ok[:, 1:] &= d9[:, 1:8] != d9[:, :7]
    ok &= d9[:, :8] != d9[:, 1:9]
    return ok


@pytest.mark.parametrize("kind", ["uniform", "surface", "grid"])
def test_knn_kernel_matches_plain(cuda, kind):
    rng = np.random.default_rng(1)
    if kind == "uniform":
        p = rng.uniform(-1, 1, (5000, 3))
        q = rng.uniform(-1, 1, (3000, 3))
    elif kind == "surface":
        th, ph = rng.uniform(0, 2 * np.pi, 9000), rng.uniform(0, np.pi, 9000)
        p = np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                      np.cos(ph)], -1)
        q = p[:2000] + rng.normal(0, 0.01, (2000, 3))
    else:                                    # exact distance ties everywhere
        ax = np.arange(20, dtype=np.float64) * 0.1
        p = np.stack(np.meshgrid(ax, ax, ax[:12], indexing="ij"), -1)
        p = p.reshape(-1, 3)
        q = p[::7] + 0.05
    p, q = p.astype(np.float32), q.astype(np.float32)
    before = knn_sq_cuda.launches
    d, i = knn(q, p, device=cuda)
    torch.cuda.synchronize()
    assert knn_sq_cuda.launches == before + 1
    d9, i9 = knn_plain(torch.from_numpy(q).to(cuda),
                       torch.from_numpy(p).to(cuda), k=9)
    torch.testing.assert_close(d, d9[:, :8], rtol=0, atol=0)
    ok = _untied(d9)
    assert torch.equal(i.long()[ok], i9[:, :8][ok])


def test_knn_kernel_unpruned_and_reused_prep(cuda):
    rng = np.random.default_rng(2)
    p = rng.uniform(-2, 2, (2100, 3)).astype(np.float32)
    prep = KnnPrep(p, device=cuda)
    for seed, prune in ((3, True), (4, False)):
        q = np.random.default_rng(seed).uniform(-2, 2, (700, 3)).astype(
            np.float32)
        pr = prep if prune else KnnPrep(p, prune=False, device=cuda)
        d, i = knn(plan=KnnQueryPlan(q, pr))
        d9, i9 = knn_plain(torch.from_numpy(q).to(cuda),
                           torch.from_numpy(p).to(cuda), k=9)
        torch.testing.assert_close(d, d9[:, :8], rtol=0, atol=0)
        ok = _untied(d9)
        assert torch.equal(i.long()[ok], i9[:, :8][ok])


def _two_clusters(seed):
    """Two far clusters with every fifth point duplicated, queries near
    both: the query tile that straddles them keeps almost every point
    tile, and many top-8 distances tie."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.5, 0.5, (40000, 3))
    b = rng.uniform(-0.5, 0.5, (40000, 3)) + 6.0
    p = np.concatenate([a, b, a[::5], b[::5]]).astype(np.float32)
    q = np.concatenate([a[:1500] + rng.normal(0, 0.01, (1500, 3)), p[:40],
                        b[:1500] + rng.normal(0, 0.01, (1500, 3))])
    return q.astype(np.float32), p


def test_knn_plan_on_the_card_equals_the_cpu_plan(cuda):
    q, p = _two_clusters(3)
    plans = {}
    for dev in (cuda, torch.device("cpu")):
        prep = KnnPrep(p, device=dev)
        plan = KnnQueryPlan(q, prep)
        plans[dev.type] = [t.cpu() for t in (
            prep.pperm, prep.ppk, prep.p_lo, prep.p_hi, plan.qperm, plan.qpk,
            plan.row_ptr, plan.tiles)] + [plan.pair_count()]
    for g, c in zip(plans["cuda"], plans["cpu"]):
        assert torch.equal(g, c) if isinstance(g, torch.Tensor) else g == c


@pytest.mark.parametrize("C", [1, 3, 32])
def test_knn_split_search_is_one_scan(cuda, C):
    """Items of C tiles and the stable merge: bit-equal, d² and indices,
    ties included, to one item a row and to the planned plain walk."""
    q, p = _two_clusters(4)
    prep = KnnPrep(p, device=cuda)
    plan = KnnQueryPlan(q, prep)
    assert plan.max_c() > 3 * C
    one = knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, plan.work(plan.max_c()),
                      prep.M)
    s0, m0 = knn_sq_cuda.launches, knn_sq_cuda.merge_launches
    split = knn_sq_cuda(plan.qpk, prep.ppk, plan.tiles, plan.work(C), prep.M)
    torch.cuda.synchronize()
    assert (knn_sq_cuda.launches - s0, knn_sq_cuda.merge_launches - m0) \
        == (1, 1)
    walk = knn_sq_planned_plain(plan.qpk, prep.ppk, plan, C)
    assert torch.equal(split[0], one[0]) and torch.equal(split[1], one[1])
    assert torch.equal(split[0], walk[0])
    assert torch.equal(split[1].long(), walk[1])
    d9, i9 = knn_sq_plain(plan.qpk, prep.ppk[:prep.M, :3], k=9)
    assert torch.equal(split[0], d9[:, :8])
    ok = _untied(d9)
    assert (~ok).any() and torch.equal(split[1].long()[ok], i9[:, :8][ok])


def test_knn_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    q, p = _two_clusters(5)
    prep = KnnPrep(p[:3000], device=cuda)
    plan = KnnQueryPlan(q[:600], prep)
    work, M = plan.work(), prep.M
    args = dict(qpk=plan.qpk, ppk=prep.ppk, tiles=plan.tiles, work=work)
    bad = [dict(qpk=plan.qpk.cpu()), dict(qpk=plan.qpk.double()),
           dict(qpk=plan.qpk[:-1]), dict(ppk=prep.ppk[:, :3].contiguous()),
           dict(qpk=plan.qpk.T.contiguous().T), dict(tiles=plan.tiles.long()),
           dict(work=dataclasses.replace(work, items=work.items[:, :3]
                                         .contiguous()))]
    for kw in bad:
        with pytest.raises(ValueError):
            knn_sq_cuda(**{**args, **kw}, m_total=M)
    with pytest.raises(ValueError):
        knn_sq_cuda(**args, m_total=prep.Mp + 1)


def test_splat_backward_on_cuda_launches_k1(cuda):
    from nerfail_tpu_torch.ops.splat import splat_gather

    M = 2000
    idx, w, mask = _skewed_tables(5, M, B=2, H=16, W=16)
    G = torch.randn(2, 16, 16, 4, generator=torch.Generator().manual_seed(5))
    G = G * mask
    pts = torch.randn(M, 4, generator=torch.Generator().manual_seed(6))
    grads, outs = [], []
    for dev in ("cpu", cuda):
        p = pts.to(dev).requires_grad_(True)
        plan = build_csr_plan(idx.to(dev), w.to(dev), M,
                              pair_mask=mask.to(dev))
        before = segment_sum.launches
        out = splat_gather(p, idx.to(dev), w.to(dev), plan=plan)
        (g,) = torch.autograd.grad(torch.sum(out * G.to(dev)), p)
        assert segment_sum.launches == before + (dev != "cpu")
        grads.append(g.cpu())
        outs.append(out.detach().cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("C", [4, 8, 32])
def test_segsum_sq_kernel_matches_plain(cuda, C, V):
    """K2 on skewed tables (half the points untouched, one very long row)
    against its plain version, within sq_error_bound, bit-equal across
    runs."""
    M = 3001
    idx, w, mask = _skewed_tables(10 * C + V, M, B=V)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M,
                                  pair_mask=mask.to(cuda))
    assert plan.n_rows <= V * (M // 2) and max(plan.view_rows) > 0
    g = torch.randn(idx[..., 0].numel(), C, generator=torch.Generator()
                    .manual_seed(C)).to(cuda)
    before = segment_sq.launches
    out = segment_sq(g, plan)
    again = segment_sq(g, plan)
    torch.cuda.synchronize()
    assert segment_sq.launches == before + 2
    assert out.shape == (V, C)
    assert torch.equal(out, again)                      # deterministic
    ref = segment_sq_plain(g, plan)
    assert ((out - ref).abs() <= sq_error_bound(g, plan)).all()
    cpu = segment_sq(g.cpu(), plan.to("cpu"))
    torch.testing.assert_close(out.cpu(), cpu, rtol=1e-5, atol=0)


def test_segsum_sq_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    M = 100
    idx, w, _ = _skewed_tables(0, M, B=2, H=4, W=4)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M)
    g = torch.randn(32, 4, device=cuda)
    with pytest.raises(ValueError):
        segment_sq(g.double(), plan)
    with pytest.raises(ValueError):
        segment_sq(torch.randn(32, 33, device=cuda), plan)
    with pytest.raises(ValueError):
        segment_sq(g, plan.to("cpu"))
    bad = dataclasses.replace(plan, view_ptr=plan.view_ptr.long())
    with pytest.raises(ValueError, match="view_ptr"):
        segment_sq(g, bad)


def test_segsum_kernel_on_batched_plan(cuda):
    """K1 over the batched plan: untouched rows zero, bit-equal across
    launches and to K1 over the one-view plan of the same pairs (ids
    offset by v·M)."""
    M, V, C = 2000, 3, 8
    idx, w, mask = _skewed_tables(7, M, B=V, H=32, W=32)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M,
                                  pair_mask=mask.to(cuda))
    off = (torch.arange(V, dtype=torch.int32) * M).view(V, 1, 1, 1)
    full = build_csr_plan((idx + off).to(cuda), w.to(cuda), V * M,
                          pair_mask=mask.to(cuda))
    g = torch.randn(V * 32 * 32, C, generator=torch.Generator()
                    .manual_seed(8)).to(cuda)
    before = segment_sum.launches
    out = segment_sum(g, plan)
    again = segment_sum(g, plan)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out, segment_sum(g, full))
    ref = segment_sum_plain(g, plan)
    assert ((out - ref).abs() <= error_bound(g, plan)).all()
    untouched = torch.ones(V * M, dtype=torch.bool, device=cuda)
    untouched[plan.rows.long()] = False
    assert untouched.any() and (out[untouched] == 0).all()


def _morton(plan, width):
    return reordered(plan, morton_order(plan, width))


@pytest.mark.parametrize("V", [1, 3])
@pytest.mark.parametrize("C", [4, 8, 12, 32])
def test_segsum_sq_launch_order(cuda, C, V):
    """K2 walked in the plan's plan-row order and in the Morton order of
    each row's first pixel: each bit-equal across launches and within
    sq_error_bound of the plain version (C = 12 takes the scalar path)."""
    M = 3001
    idx, w, mask = _skewed_tables(20 * C + V, M, B=V)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M,
                                  pair_mask=mask.to(cuda))
    zplan = _morton(plan, 64)
    assert not torch.equal(zplan.launch_rows, plan.launch_rows)
    g = torch.randn(idx[..., 0].numel(), C, generator=torch.Generator()
                    .manual_seed(C + V)).to(cuda)
    ref = segment_sq_plain(g, plan)
    bound = sq_error_bound(g, plan)
    for p in (plan, zplan):
        out = segment_sq(g, p)
        again = segment_sq(g, p)
        torch.cuda.synchronize()
        assert torch.equal(out, again)
        assert ((out - ref).abs() <= bound).all()


@pytest.mark.parametrize("C", [1, 4, 7, 32])
def test_segsum_launch_order_is_bit_equal(cuda, C):
    """K1 in plan-row order, in Morton order and on the plan stored in
    Morton order: the same bits, each row summed alone."""
    M, V = 2500, 2
    idx, w, mask = _skewed_tables(30 + C, M, B=V, H=48, W=40)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M,
                                  pair_mask=mask.to(cuda))
    g = torch.randn(idx[..., 0].numel(), C, generator=torch.Generator()
                    .manual_seed(C)).to(cuda)
    out = segment_sum(g, plan)
    zplan = _morton(plan, 40)
    for p in (zplan, stored_in_launch_order(zplan)):
        assert torch.equal(segment_sum(g, p), out)
    assert ((out - segment_sum_plain(g, plan)).abs()
            <= error_bound(g, plan)).all()


@pytest.mark.parametrize("C", [4, 8])
def test_segsum_class_reads_the_stack_in_place(cuda, C):
    """The in-place pick: bit-equal to K1 on the copied class and across
    launches, untouched rows zero, one K1 launch, the class tensor on the
    card or on the host."""
    M, V, ncls = 2000, 3, 8
    idx, w, mask = _skewed_tables(40 + C, M, B=V, H=32, W=32)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M,
                                  pair_mask=mask.to(cuda))
    stack = torch.randn(V * 32 * 32, ncls * C, generator=torch.Generator()
                        .manual_seed(C)).to(cuda)
    cls = torch.tensor([5, 0, 7])
    before = segment_sum.launches
    out = segment_sum_class(stack, cls.to(cuda), plan, C)
    again = segment_sum_class(stack, cls.to(cuda, torch.int32), plan, C)
    host = segment_sum_class(stack, cls, plan, C)
    torch.cuda.synchronize()
    assert segment_sum.launches == before + 3
    assert torch.equal(out, again) and torch.equal(out, host)
    gsel = class_rows(stack, cls, plan, C)
    assert torch.equal(gsel, stack.view(V, -1, ncls, C)[
        torch.arange(V, device=cuda), :, cls.to(cuda)].reshape(-1, C))
    assert torch.equal(out, segment_sum(gsel, plan))
    assert torch.equal(segment_sum_class(stack, cls, _morton(plan, 32), C),
                       out)
    untouched = torch.ones(V * M, dtype=torch.bool, device=cuda)
    untouched[plan.rows.long()] = False
    assert untouched.any() and (out[untouched] == 0).all()
    assert (out[~untouched] != 0).any()


def test_segsum_class_rejects_what_the_kernel_cannot_take(cuda):
    M, V, ncls = 100, 2, 8
    idx, w, _ = _skewed_tables(0, M, B=V, H=4, W=4)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), M)
    stack = torch.randn(V * 16, ncls * 4, device=cuda)
    cls = torch.tensor([1, 2], device=cuda)
    segment_sum_class(stack, cls, plan)
    bad = [
        dict(stack=stack.double()),                       # dtype
        dict(stack=stack[:, :30]),                        # stride, width
        dict(stack=stack.T.contiguous().T),               # not contiguous
        dict(stack=stack[:-1]),                           # pixels
        dict(cls=cls.float()),                            # class dtype
        dict(cls=cls[:1]),                                # one per view
        dict(cls=torch.tensor([0, ncls])),                # class range
        dict(cls=torch.tensor([-1, 0])),
        dict(plan=plan.to("cpu")),
        dict(plan=dataclasses.replace(
            plan, launch_rows=plan.launch_rows.long())),
        dict(plan=dataclasses.replace(
            plan, launch_rows=plan.launch_rows[:-1])),
        dict(plan=dataclasses.replace(
            plan, launch_rows=plan.launch_rows[:, :3].contiguous())),
    ]
    for kw in bad:
        args = {"stack": stack, "cls": cls, "plan": plan, **kw}
        with pytest.raises(ValueError):
            segment_sum_class(args["stack"], args["cls"], args["plan"])
    with pytest.raises(ValueError):
        segment_sum_class(stack, cls, plan, channels=33)


_BAD_CLASS = """
import sys
import torch
from nerfail_tpu_torch.ops.cuda.segsum_kernel import (
    build_batched_csr_plan, segment_sum_class,
)
dev = torch.device("cuda")
gen = torch.Generator().manual_seed(0)
idx = torch.randint(0, 50, (2, 4, 4, 8), generator=gen, dtype=torch.int32)
w = torch.rand(2, 4, 4, 8, generator=gen)
plan = build_batched_csr_plan(idx.to(dev), w.to(dev), 50)
stack = torch.randn(2 * 16, 8 * 4, device=dev)
cls = torch.tensor([1, int(sys.argv[1])], device=dev)
segment_sum_class(stack, cls, plan)
print("launched", flush=True)
torch.cuda.synchronize()
print("finished", flush=True)
"""


@pytest.mark.parametrize("bad", [-1, 8, 1 << 20])
def test_segsum_class_traps_on_a_class_out_of_range_on_the_card(cuda, bad):
    """A class tensor on the card is not read back by the wrapper: K1
    checks each view's class and stops with a device fault instead of
    reading another pixel's channels or past the stack (8 classes here).
    The fault ends the CUDA context, so the pick runs in a process of its
    own; the kernel is built here first, and the process loads it."""
    idx, w, _ = _skewed_tables(0, 100, B=2, H=4, W=4)
    plan = build_batched_csr_plan(idx.to(cuda), w.to(cuda), 100)
    stack = torch.randn(2 * 16, 8 * 4, device=cuda)
    ok = segment_sum_class(stack, torch.tensor([1, 7], device=cuda), plan)
    torch.cuda.synchronize()
    assert torch.isfinite(ok).all()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = subprocess.run([sys.executable, "-c", _BAD_CLASS, str(bad)],
                         cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert "launched" in run.stdout, run.stderr
    assert "finished" not in run.stdout
    assert run.returncode != 0 and "CUDA error" in run.stderr, run.stderr


def test_deepfool_engine_on_cuda_launches_k2_and_k1(cuda):
    """splat_deepfool_engine on the card: one K2 launch for the class
    norms, one K1 launch per pick, and the CPU engine's numbers."""
    from nerfail_tpu_torch.ops.splat import splat_deepfool_engine

    M, V, ncls = 1500, 2, 8
    idx, w, mask = _skewed_tables(9, M, B=V, H=16, W=16)
    gen = torch.Generator().manual_seed(10)
    pts = torch.randn(V, M, 4, generator=gen)
    Wc = torch.randn(16 * 16 * 4, ncls, generator=gen) * 1e-2
    ori = torch.tensor([1, 6])
    k = torch.tensor([3, 0])
    got = []
    for dev in ("cpu", cuda):
        m = mask.to(dev)
        plan = build_batched_csr_plan(idx.to(dev), w.to(dev), M, pair_mask=m)
        Wd = Wc.to(dev)

        def head(pix):
            return torch.tanh((pix * m).reshape(V, -1)) @ Wd

        k2, k1 = segment_sq.launches, segment_sum.launches
        logits, sq, pick = splat_deepfool_engine(
            head, pts.to(dev), idx.to(dev), w.to(dev), plan, ncls,
            ori.to(dev))
        gk = pick(k.to(dev))
        torch.cuda.synchronize()
        assert segment_sq.launches - k2 == (dev != "cpu")
        assert segment_sum.launches - k1 == (dev != "cpu")
        got.append([t.cpu() for t in (logits, sq, gk)])
    for c, g in zip(*got):
        torch.testing.assert_close(g, c, rtol=1e-4, atol=1e-6)


@functools.lru_cache(maxsize=1)
def _scene32():
    """The attacked box scene at 32²: 6 views (class 0), the point set of
    mask views 0-2, 8-NN tables built on the CPU with the Gaussian width
    scaled from 800², δ0, and a seeded linear classifier's weights (8
    classes; small enough that DeepFool flips views within 20
    iterations)."""
    from nerfail_tpu_torch.attacks.forward import zero_init_mask
    from nerfail_tpu_torch.config import PointSetConfig
    from nerfail_tpu_torch.data.synthetic import analytic_coord_map
    from nerfail_tpu_torch.eval.asr_800 import attack_scene, attack_views
    from nerfail_tpu_torch.pointset.extract import build_neighbor_tables

    size, masks = 32, [0, 1, 2]
    K, poses = attack_scene(6, size)
    ori, S = attack_views(K, poses, size, masks)
    coords = np.stack([analytic_coord_map(p, size, size, K) for p in poses])
    w, idx = build_neighbor_tables(
        coords, S, PointSetConfig(gauss_c=0.02 * 800 / size), device="cpu")
    return {"ori": ori, "w": w, "idx": idx, "masks": ori[masks],
            "delta0": zero_init_mask(ori[masks].astype(np.float32)).numpy(),
            "Wc": (np.random.default_rng(4).standard_normal(
                (size * size * 3, 8)) * 1e-3).astype(np.float32)}


def _linear_logits(sc, dev):
    from nerfail_tpu_torch.tools.parallel_checks import linear_logits_fn

    return linear_logits_fn(sc["Wc"], dev)


def _deepfool_loops(history, max_iter):
    """Engine evaluations that a NeRFail history implies: each batch walks
    once per iteration of its slowest view, plus once to see every view
    flipped unless all froze at max_iter."""
    return sum(max(min(i + 1, max_iter) for i in b)
               for h in history for b in h["deepfool_iters"])


def test_nerfail_s_on_the_card_matches_the_cpu(cuda):
    """nerfail_s_attack at 32² (6 views, batch 4, 2 epochs) on the card
    and on the CPU: one K1 launch a step and no other kernel on the card,
    none on the CPU, the clean accuracy of every epoch equal, δ equal on
    ≥ 99 % of its entries."""
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig

    sc = _scene32()
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    runs, launched = {}, {}
    for dev in (cuda, torch.device("cpu")):
        before = _launches()
        runs[dev.type] = nerfail_s_attack(
            sc["delta0"], sc["w"], sc["idx"], sc["ori"], np.zeros(6, np.int64),
            _linear_logits(sc, dev), cfg, resize_to=None, epochs=2,
            device=dev)
        launched[dev.type] = _since(before)
    assert launched["cuda"] == {"K1": 2 * 2, "K2": 0, "K3": 0, "K4": 0,
                                "K5": 0}
    assert not any(launched["cpu"].values())
    assert [h["clean_acc"] for h in runs["cuda"].history] == \
        [h["clean_acc"] for h in runs["cpu"].history]
    assert np.mean(runs["cuda"].delta == runs["cpu"].delta) >= 0.99


def test_nerfail_s_prefetched_tables_equal_resident_ones(cuda, tmp_path):
    """nerfail_s_attack at 32² (6 views, batch 2, 3 epochs) with a plan
    cache that keeps every batch on the card, and, under device_trace,
    with one that keeps none there, so that each get of epochs 1 and 2
    takes tables that a prefetch sent during the step before: δ and the
    history bit-equal, and `plan_cache.prefetched_gets` equal to
    `streamed_gets` (6). A second session in the process then still reads
    device time."""
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.utils import profiling as prof
    from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache

    sc = _scene32()
    cfg = AttackConfig(eps=32.0, a=2.0, batch_size=2)

    def run(budget):
        return nerfail_s_attack(
            sc["delta0"], sc["w"], sc["idx"], sc["ori"],
            np.zeros(6, np.int64), _linear_logits(sc, cuda), cfg,
            resize_to=None, epochs=3,
            plan_cache=DeviceBudgetCache(budget, device=cuda), device=cuda)

    resident = run(1 << 30)
    with prof.device_trace(str(tmp_path / "streamed")):
        streamed = run(0)
    counters = prof.trace_record()["counters"]
    np.testing.assert_array_equal(streamed.delta, resident.delta)
    assert np.any(resident.delta[..., :3] != 0)
    acc = lambda r: [(h["epoch"], h["attack_acc"], h["clean_acc"])  # noqa
                     for h in r.history]
    assert acc(streamed) == acc(resident)
    assert counters["plan_cache.streamed_gets"] == 2 * 3
    assert counters["plan_cache.prefetched_gets"] == 2 * 3
    a = torch.randn(1024, 1024, device=cuda)
    with prof.device_trace(str(tmp_path / "after")) as p:
        a @ a
        prof.fence(a)
    assert sum(e.self_device_time_total for e in p.key_averages()) > 0


def test_nerfail_s_steps_wait_only_in_the_prefetch(cuda, monkeypatch):
    """Epoch 1 of nerfail_s_attack at 32² (6 views, batch 2, every batch
    streamed and prefetched, resized to 16² for a linear classifier), from
    its first get to the end of its last step, under
    torch.cuda.set_sync_debug_mode("error"): nothing calls a synchronising
    CUDA function. That mode does not see event waits, so
    torch.cuda.Event.synchronize is counted apart: each prefetch waits on
    one event (the one wait that keeps the host within a batch of the
    card), and nothing else in the steps waits on one. The last step
    prefetches nothing: no step follows it. The epoch end's tolist() is
    outside the window."""
    from nerfail_tpu_torch.attacks import nerfail_s
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache

    sc = _scene32()
    n_batches = 3
    Wc = torch.randn(16 * 16 * 3, 8, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0)) * 1e-3
    cache = DeviceBudgetCache(0, device=cuda)
    gets, steps, prefetches, waits, inside = [], [], [], [], []
    window = lambda: len(gets) > n_batches and len(steps) < 2 * n_batches  # noqa

    def get(key, build, real=cache.get):
        gets.append(key)
        if len(gets) == n_batches + 1:
            torch.cuda.set_sync_debug_mode("error")
        return real(key, build)

    def prefetch(key, real=cache.prefetch):
        if window():
            prefetches.append(key)
        inside.append(key)
        try:
            real(key)
        finally:
            inside.pop()

    def synchronize(event, real=torch.cuda.Event.synchronize):
        if window():
            waits.append(bool(inside))
        return real(event)

    make = nerfail_s.make_nerfail_s_step

    def make_step(*args, **kwargs):
        step = make(*args, **kwargs)

        def counted(*batch):
            out = step(*batch)
            steps.append(len(steps))
            if len(steps) == 2 * n_batches:
                torch.cuda.set_sync_debug_mode(0)
            return out

        return counted

    cache.get, cache.prefetch = get, prefetch
    monkeypatch.setattr(torch.cuda.Event, "synchronize", synchronize)
    monkeypatch.setattr(nerfail_s, "make_nerfail_s_step", make_step)
    try:
        nerfail_s.nerfail_s_attack(
            sc["delta0"], sc["w"], sc["idx"], sc["ori"],
            np.zeros(6, np.int64),
            lambda x: x.reshape(x.shape[0], -1) @ Wc,
            AttackConfig(eps=32.0, a=2.0, batch_size=2), resize_to=16,
            epochs=2, plan_cache=cache, device=cuda)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert steps == list(range(2 * n_batches))
    assert gets == [0, 2, 4] * 2
    assert prefetches == [2, 4]
    assert waits == [True, True]


def test_resize_on_the_card_copies_nothing_from_the_host(cuda):
    """resize_batch on the card, 800² → 299², bit-equal to the products
    with the numpy matrices sent to the card on each call; a second call
    runs under torch.cuda.set_sync_debug_mode("error"), where sending a
    matrix from pageable host memory, as each call once did, raises."""
    from nerfail_tpu_torch.attacks.forward import _resize_weights, resize_batch

    x = torch.rand(2, 800, 800, 3, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0)) * 255.0
    got = resize_batch(x, 299)
    want = x
    for axis in (2, 1):
        A = torch.from_numpy(_resize_weights(800, 299)).to(cuda)
        want = torch.movedim(
            torch.matmul(torch.movedim(want, axis, -1), A.T), -1, axis)
    assert torch.equal(got, want)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.from_numpy(_resize_weights(800, 299)).to(cuda)
        again = resize_batch(x, 299)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, got)


def test_nerfail_on_the_card_matches_the_cpu(cuda):
    """nerfail_attack at 32² (m1 2, m2 100, ≤ 20 DeepFool iterations, view
    batch 3, 3 epochs) on the card and on the CPU: the same control plane
    (m1, m2, attack accuracy, DeepFool calls), views that flip, δ within
    1e-2, each DeepFool batch of the history a view batch of per-view
    iterations, and on the card one K2 launch (the class norms) and one
    K1 launch (the pick) per DeepFool iteration that those iterations
    imply."""
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.config import AttackConfig

    sc = _scene32()
    cfg = AttackConfig(eps=32.0, m1=2.0, m2=100.0, df_max_iter=20,
                       view_batch=3)
    runs, launched = {}, {}
    for dev in (cuda, torch.device("cpu")):
        before = _launches()
        runs[dev.type] = nerfail_attack(
            sc["delta0"], sc["w"], sc["idx"], sc["ori"],
            _linear_logits(sc, dev), cfg, resize_to=None, epochs=3,
            device=dev)
        launched[dev.type] = _since(before)
    keys = ("epoch", "m1", "m2", "attack_acc", "deepfool_calls")
    hist = {d: [{k: h[k] for k in keys} for h in r.history]
            for d, r in runs.items()}
    assert hist["cuda"] == hist["cpu"]
    assert min(h["attack_acc"] for h in hist["cuda"]) < 1.0    # views flip
    assert np.abs(runs["cuda"].delta - runs["cpu"].delta).max() <= 1e-2
    for h in runs["cuda"].history:
        iters = h["deepfool_iters"]
        assert all(len(b) == cfg.view_batch for b in iters)
        assert h["deepfool_calls"] <= cfg.view_batch * len(iters)
        assert (h["deepfool_calls"] == 0) == (not iters)
    loops = _deepfool_loops(runs["cuda"].history, cfg.df_max_iter)
    assert loops > 0
    assert launched["cuda"] == {"K1": loops, "K2": loops, "K3": 0, "K4": 0,
                                "K5": 0}
    assert not any(launched["cpu"].values())


def test_pipeline_stage_attack_launches_on_the_card(cuda, tmp_path):
    """The four engines through Pipeline.stage_attack on the card at 32²
    (NeRFail for 2 epochs: one DeepFool epoch and the final evaluation):
    both 3D engines launch K1, NeRFail K2 as well, and the 2D engines no
    kernel of the port."""
    from nerfail_tpu_torch.config import (
        SCENE_CLASSES, AttackConfig, ExperimentConfig,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout, Pipeline

    sc = _scene32()
    pipe = Pipeline(ArtifactLayout(str(tmp_path)), ExperimentConfig(),
                    device=cuda)
    logits_fn = _linear_logits(sc, cuda)
    got = {}
    for method, epochs in (("NeRFail_S", 1), ("NeRFail", 2), ("IGSM_2D", 1),
                           ("Universal_2D", 1)):
        acfg = AttackConfig(method=method, eps=32.0, a=2.0, m1=2.0, m2=100.0,
                            df_max_iter=20, batch_size=4, view_batch=3,
                            attack_epochs=epochs)
        before = _launches()
        pipe.stage_attack(method, acfg, SCENE_CLASSES[0], "linear",
                          logits_fn, None, sc["ori"],
                          tables=(sc["w"], sc["idx"]),
                          mask_images=sc["masks"], epochs=epochs)
        got[method] = _since(before)
    assert got["NeRFail_S"]["K1"] > 0 and got["NeRFail"]["K1"] > 0
    assert got["NeRFail"]["K2"] > 0 and got["NeRFail_S"]["K2"] == 0
    for method in ("NeRFail_S", "NeRFail"):
        assert got[method]["K3"] == got[method]["K4"] == \
            got[method]["K5"] == 0
    for method in ("IGSM_2D", "Universal_2D"):
        assert not any(got[method].values()), (method, got[method])


def _mlp_case(cfg, n, seed, device):
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        MlpDims, pack_input, pack_params,
    )

    dims = MlpDims.from_cfg(cfg)
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, device)
    fw, fb = (t.detach().contiguous() for t in pack_params(params, dims))
    gen = torch.Generator().manual_seed(seed + 1)
    pts = torch.rand(n, 3, generator=gen) * 4.0 - 2.0
    vd = torch.nn.functional.normalize(torch.randn(n, 3, generator=gen), dim=-1)
    g = torch.randn(n, 4, generator=gen)
    return dims, pack_input(pts, vd).to(device), fw, fb, g.to(device)


def _close(got, want, frac=0.02):
    scale = float(want.detach().abs().max())
    assert float((got - want).detach().abs().max()) <= frac * scale + 1e-30, (
        float((got - want).detach().abs().max()), scale)


_MLP_CFGS = [dict(netdepth=2, netwidth=64, skips=(0,), multires=4,
                  multires_views=2),
             dict(netdepth=4, netwidth=128, skips=(1,)),
             dict()]


def _check_k4(cuda, cfg, n, seed):
    """K4 against its plain version: bit-equal across launches, layer 0
    within the f32 summation bound, the output within 2 %."""
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        _encode, _r, mlp_forward, mlp_forward_plain, mlp_layer0_plain,
    )

    dims, xin, fw, fb, _ = _mlp_case(cfg, n, seed, cuda)
    before = mlp_forward.launches
    z0 = torch.empty(xin.shape[0], dims.width, device=cuda)
    out = mlp_forward(xin, fw, fb, dims, z0=z0)
    again = mlp_forward(xin, fw, fb, dims)
    torch.cuda.synchronize()
    assert mlp_forward.launches == before + 2
    assert torch.equal(out, again)
    assert torch.isfinite(out).all()
    _close(out, mlp_forward_plain(xin, fw, fb, dims))
    # layer 0: same bf16 operands (the encoding's sinf/cosf match torch's
    # on the card), f32 sums of K products in two orders: each within
    # K·2u·Σ|a·b| of the exact sum even if the tensor cores truncate
    ref = mlp_layer0_plain(xin, fw, fb, dims)
    enc = _r(_encode(xin, dims.multires, 0, dims.in_pad)[0])
    w0 = _r(fw[:dims.in_pad * dims.width].view(dims.in_pad, dims.width))
    bound = 2 * (dims.in_pad + 2) * 2.0 ** -23 * (enc.abs() @ w0.abs()
                                              + fb[:dims.width].abs())
    assert bool(((z0 - ref).abs() <= bound).all())


@pytest.mark.parametrize("kw", _MLP_CFGS)
def test_nerf_mlp_forward_matches_plain(cuda, kw):
    from nerfail_tpu_torch.config import NeRFModelConfig

    _check_k4(cuda, NeRFModelConfig(**kw), 2048, 0)


# K4's persistent kernel at widths 32, 96, 128, 160, 192, 224 and 256
# (the ring holds 8 stages up to 128, then 7, 6, 4 and 4; a 128-channel
# encoding leaves 3 at 256), at depth 1 and with skips (2, 5); each at a
# lone 64-row half tile, one and a half tiles, and (on a 132-SM card)
# three waves of tiles and a half
_K4_CFGS = {"W32": dict(netdepth=2, netwidth=32, skips=()),
            "W96": dict(netdepth=3, netwidth=96, skips=(1,)),
            "W128": dict(netdepth=4, netwidth=128),
            "W160": dict(netwidth=160),
            "W192": dict(netwidth=192),
            "W224": dict(netwidth=224),
            "W256": dict(),
            "W256-3-stages": dict(multires=20),
            "D1": dict(netdepth=1, netwidth=64, skips=()),
            "skips-2-5": dict(netdepth=8, netwidth=128, skips=(2, 5))}


@pytest.mark.parametrize("name", list(_K4_CFGS))
@pytest.mark.parametrize("n", [64, 192, 132 * 128 * 3 + 64])
def test_k4_persistent_kernel_matches_plain(cuda, name, n):
    from nerfail_tpu_torch.config import NeRFModelConfig

    _check_k4(cuda, NeRFModelConfig(**_K4_CFGS[name]), n, 4)


def test_k4_full_width_bit_equal_across_launches(cuda):
    """8×256 over three waves of tiles and a half, the last consumer with
    no rows: the consumers and the producer interleave differently from
    launch to launch, the bits do not."""
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_forward

    dims, xin, fw, fb, _ = _mlp_case(NeRFModelConfig(), 132 * 128 * 3 + 64,
                                     5, cuda)
    outs = [mlp_forward(xin, fw, fb, dims) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])


@pytest.mark.parametrize("width", range(32, 257, 32))
def test_k4_ring_plan_matches_its_python_mirror(cuda, width):
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        MlpDims, k4_stages, kernel_sizes,
    )

    for cfg in (NeRFModelConfig(netwidth=width),
                NeRFModelConfig(netwidth=width, netdepth=2, skips=(),
                                multires=20)):
        dims = MlpDims.from_cfg(cfg)
        assert kernel_sizes(dims)[6] == k4_stages(dims)


# (config, rows): the small configs, and 8×256 at the rows of a coarse
# (1024 × 64) and a fine (1024 × 192) train-step pass; at 65 536 rows K5b's
# last point split is shorter than the others
_K5_CASES = [(kw, 4096) for kw in _MLP_CFGS] + [({}, 65536), ({}, 196608)]


@pytest.mark.parametrize("kw,n", _K5_CASES,
                         ids=[f"{i}-{n}" for i, (_, n) in enumerate(_K5_CASES)])
@pytest.mark.parametrize("input_grads", [False, True])
def test_nerf_mlp_backward_matches_plain(cuda, kw, n, input_grads):
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        MlpDims, mlp_backward, mlp_backward_plain, wgrad_chunk, wgrad_tiles,
    )

    dims, xin, fw, fb, g = _mlp_case(NeRFModelConfig(**kw), n, 1, cuda)
    if n == 65536:
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        assert n % wgrad_chunk(n, len(wgrad_tiles(dims)), sms) != 0
    before = mlp_backward.launches
    dx, dw, db = mlp_backward(xin, fw, fb, g, dims, input_grads)
    dx2, dw2, db2 = mlp_backward(xin, fw, fb, g, dims, input_grads)
    torch.cuda.synchronize()
    assert mlp_backward.launches == before + 2
    assert torch.equal(dw, dw2) and torch.equal(db, db2)
    rx, rw, rb = mlp_backward_plain(xin, fw, fb, g, dims, input_grads)
    assert torch.isfinite(dw).all() and torch.isfinite(db).all()
    o = 0
    for k, m in dims.w_shapes():
        _close(dw[o:o + k * m], rw[o:o + k * m])
        o += k * m
    o = 0
    for m in dims.b_sizes():
        _close(db[o:o + m], rb[o:o + m])
        o += m
    if input_grads:
        assert torch.equal(dx, dx2)
        # the encoding jacobian scales a channel's gradient by its
        # frequency (up to 2⁹) and sums 63 terms that cancel: d_pts is
        # held by its relative L2 error
        assert float((dx - rx).norm() / rx.norm()) <= 0.02
    else:
        assert dx is None and rx is None


@pytest.mark.parametrize("kw", _MLP_CFGS)
def test_nerf_mlp_backward_bit_equal_and_flag_free(cuda, kw):
    """K5 gives the same bits on every launch, and the same dW/db whether
    or not input gradients are asked for (no float atomics; the point
    splits depend only on the rows, the architecture and the card)."""
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward

    dims, xin, fw, fb, g = _mlp_case(NeRFModelConfig(**kw), 65536, 2, cuda)
    runs = [mlp_backward(xin, fw, fb, g, dims, flag)
            for flag in (False, True, False, True)]
    torch.cuda.synchronize()
    assert runs[0][0] is None and runs[1][0] is not None
    assert torch.equal(runs[1][0], runs[3][0])
    for dx, dw, db in runs[1:]:
        assert torch.equal(dw, runs[0][1]) and torch.equal(db, runs[0][2])


def test_nerf_mlp_fused_autograd_on_cuda(cuda):
    """nerf_mlp_fused through K4/K5 against the same call on the CPU
    (the plain versions): raw output, parameter grads and d_pts."""
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        mlp_backward, mlp_forward, nerf_mlp_fused,
    )

    cfg = NeRFModelConfig(netdepth=4, netwidth=128)
    gen = torch.Generator().manual_seed(3)
    pts = torch.rand(1000, 3, generator=gen) * 4.0 - 2.0
    vd = torch.nn.functional.normalize(torch.randn(1000, 3, generator=gen), dim=-1)
    got = {}
    for dev in (cuda, torch.device("cpu")):
        p = init_nerf_params(torch.Generator().manual_seed(0), cfg, dev)
        x = pts.to(dev).requires_grad_(True)
        f0, b0 = mlp_forward.launches, mlp_backward.launches
        raw = nerf_mlp_fused(p, cfg, x, vd.to(dev))
        grads = torch.autograd.grad(torch.tanh(raw).sum(),
                                    [x] + list(p.values()))
        launched = (mlp_forward.launches - f0, mlp_backward.launches - b0)
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
        got[dev.type] = [raw] + list(grads)
    for j, (a, b) in enumerate(zip(got["cuda"], got["cpu"])):
        if j == 1:                                        # d_pts
            assert float((a.cpu() - b).norm() / b.norm()) <= 0.02
        else:
            _close(a.cpu(), b)


def test_nerf_mlp_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    from nerfail_tpu_torch.config import NeRFModelConfig
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import mlp_backward, mlp_forward

    dims, xin, fw, fb, g = _mlp_case(NeRFModelConfig(netdepth=2, netwidth=64),
                                     128, 0, cuda)
    with pytest.raises(ValueError):
        mlp_forward(xin[:100], fw, fb, dims)            # not a multiple of 64
    with pytest.raises(ValueError):
        mlp_forward(xin, fw.double(), fb, dims)
    with pytest.raises(ValueError):
        mlp_forward(xin, fw[:-1], fb, dims)
    with pytest.raises(ValueError):                     # z0 must be [n, W]
        mlp_forward(xin, fw, fb, dims, z0=torch.empty(128, 32, device=cuda))
    with pytest.raises(ValueError):
        mlp_backward(xin, fw, fb, g[:, :3].contiguous(), dims, False)


def _zoo_names():
    from nerfail_tpu_torch.models.classifiers import CLASSIFIER_REGISTRY

    return list(CLASSIFIER_REGISTRY)


@pytest.mark.parametrize("name", _zoo_names())
def test_zoo_model_on_the_card_matches_the_cpu(cuda, name):
    """Every registry entry at its input size, eval mode, batch 1: the
    CUDA logits within 1e-3 of the largest CPU logit (fp32 with TF32 off,
    summed in other orders by cuDNN / cuBLAS and the CPU kernels), and
    the input gradient of the cross-entropy on the card finite and not
    all zero, as the attacks take it."""
    import torch.nn.functional as F

    from nerfail_tpu_torch.models.classifiers import (
        classifier_input_size, get_classifier,
    )

    torch.manual_seed(0)
    model = get_classifier(name).eval()
    size = classifier_input_size(name) or 800
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32))
    with torch.no_grad():
        want = model(x)
    xg = x.to(cuda).requires_grad_(True)
    logits = model.to(cuda)(xg)
    (grad,) = torch.autograd.grad(
        F.cross_entropy(logits, torch.zeros(1, dtype=torch.int64,
                                            device=cuda)), xg)
    got = logits.detach().cpu()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale
    assert grad.shape == xg.shape and torch.isfinite(grad).all()
    assert float(grad.abs().max()) > 0


def test_inception_aux_head_train_mode_on_the_card(cuda):
    """Train mode on the card returns (logits, aux); aux and the moved
    BatchNorm statistics agree with the CPU's (dropout draws differ, so
    the logits are not compared) within 1e-3 of their largest entry."""
    from nerfail_tpu_torch.models.classifiers.inception_v3 import InceptionV3

    torch.manual_seed(0)
    cpu_model = InceptionV3().train()
    dev_model = InceptionV3().to(cuda).train()
    dev_model.load_state_dict(cpu_model.state_dict())
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 255, (2, 299, 299, 3)).astype(np.float32))
    with torch.no_grad():
        _, aux_cpu = cpu_model(x)
        logits, aux = dev_model(x.to(cuda))
    assert logits.shape == aux.shape == (2, 8)
    assert float((aux.cpu() - aux_cpu).abs().max()) <= \
        1e-3 * float(aux_cpu.abs().max())
    want, got = cpu_model.state_dict(), dev_model.state_dict()
    for k in want:
        if "running" in k:
            assert float((got[k].cpu() - want[k]).abs().max()) <= \
                1e-3 * float(want[k].abs().max()) + 1e-7, k


def test_render_path_writes_readable_pngs_on_the_card(cuda, tmp_path):
    """render_path(save_dir=...) on the card writes NNN.png through
    utils/png (the card's machine has no imageio); each reads back as the
    to8b of its render."""
    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig,
    )
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.render_path import render_path, to8b
    from nerfail_tpu_torch.utils.png import imread

    cfg = ExperimentConfig(
        model=NeRFModelConfig(netdepth=2, netwidth=64),
        render=RenderConfig(N_samples=16, N_importance=16, chunk=4096))
    gen = torch.Generator().manual_seed(0)
    params = {"coarse": init_nerf_params(gen, cfg.model, cuda),
              "fine": init_nerf_params(gen, cfg.model, cuda)}
    sc = make_box_scene(n_train=3, n_val=0, n_test=0, H=32, W=32)
    rgbs, _ = render_path(params, cfg, sc.poses, 32, 32, sc.K,
                          save_dir=str(tmp_path), save_coords=True)
    for i in range(3):
        img = imread(str(tmp_path / f"{i:03d}.png"))
        assert img.shape == (32, 32, 3)
        np.testing.assert_array_equal(img, to8b(rgbs[i]))
        assert np.load(str(tmp_path / f"{i:03d}.npy")).shape == (32, 32, 3)


@pytest.mark.parametrize("batched", [False, True])
def test_universal_2d_forward_on_the_card_matches_the_cpu(cuda, batched):
    """The 2D baselines' forward (broadcast add, clip, composite, resize,
    classify) on CUDA against the CPU path: images within 1e-3 on the
    0-255 scale, logits within 1e-3 of their largest entry."""
    from nerfail_tpu_torch.attacks.forward import (
        make_classifier_logits_fn, universal_2d_forward,
    )
    from nerfail_tpu_torch.models.classifiers.simple_cnn import SimpleCNN

    rng = np.random.default_rng(0)
    ori = rng.uniform(0, 255, (4, 64, 64, 4)).astype(np.float32)
    ori[..., 3] *= rng.uniform(size=(4, 64, 64)) > 0.3
    shape = (4, 64, 64, 3) if batched else (64, 64, 3)
    delta = rng.uniform(-32, 32, shape).astype(np.float32)
    torch.manual_seed(0)
    model = SimpleCNN(num_classes=8)
    with torch.no_grad():
        want = universal_2d_forward(delta, ori,
                                    make_classifier_logits_fn(model), 48,
                                    device="cpu")
        got = universal_2d_forward(
            delta, ori, make_classifier_logits_fn(model.to(cuda)), 48,
            device=cuda)
    np.testing.assert_allclose(got["attacked_rgb"].cpu().numpy(),
                               want["attacked_rgb"].numpy(), atol=1e-3,
                               rtol=0)
    for k in ("logits", "ori_logits"):
        w = want[k].numpy()
        assert float(np.abs(got[k].cpu().numpy() - w).max()) <= \
            1e-3 * max(float(np.abs(w).max()), 1e-6)


def _multi_step_case(dev, n_imp=8):
    from nerfail_tpu_torch.config import (
        NeRFModelConfig, RenderConfig, TrainConfig,
    )

    mcfg = NeRFModelConfig(netdepth=2, netwidth=64, skips=(0,), multires=4,
                           multires_views=2)
    rcfg = RenderConfig(N_samples=16, N_importance=n_imp, chunk=1024)
    tcfg = TrainConfig(N_rand=128, precrop_iters=0)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.uniform(0, 1, (3, 16, 16, 3)).astype(
        np.float32)).to(dev)
    poses = torch.eye(4).expand(3, 4, 4).clone()
    poses[:, 2, 3] = 4.0
    poses[:, 0, 3] = torch.tensor([-0.5, 0.0, 0.5])
    K = torch.tensor([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]])
    return mcfg, rcfg, tcfg, images, poses.to(dev), K.to(dev)


def test_multi_step_captured_window_equals_the_eager_loop(cuda):
    """Two replays of a captured k = 3 window against six make_train_step
    steps on the card with the same (seed, i) draws and the same
    capturable Adam (make_capturable, as the capture converts the state's):
    parameters and Adam's moments bit-equal (K4/K5 use no float atomics).
    K4 and K5 are launched by the warm-up step and recorded 2k times each
    by the capture; replays go through no wrapper."""
    from nerfail_tpu_torch.ops.cuda.mlp_kernel import (
        mlp_backward, mlp_forward,
    )
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_capturable, make_multi_train_step,
        make_train_step, sample_rays, step_seed,
    )

    mcfg, rcfg, tcfg, images, poses, K = _multi_step_case(cuda)
    ref = create_train_state(0, mcfg, rcfg, tcfg, cuda)
    make_capturable(ref.opt_state)
    step = make_train_step(mcfg, rcfg, tcfg)
    gen = torch.Generator(device=cuda)
    for i in range(6):
        gen.manual_seed(step_seed(5, i))
        batch = sample_rays(gen, images, poses, K, tcfg.N_rand, False,
                            tcfg.precrop_frac, tcfg.no_batching)
        m_ref = step(ref, batch, gen, (16, 16), 20.0)
    state = create_train_state(0, mcfg, rcfg, tcfg, cuda)
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=3)
    f0, b0 = mlp_forward.launches, mlp_backward.launches
    multi(state, images, poses, K, 5)
    assert (mlp_forward.launches - f0, mlp_backward.launches - b0) == (
        2 + 6, 2 + 6)
    m = multi(state, images, poses, K, 5)
    assert (mlp_forward.launches - f0, mlp_backward.launches - b0) == (8, 8)
    torch.cuda.synchronize()
    assert state.step == ref.step == 6
    assert torch.equal(m["loss"], m_ref["loss"])
    for net in ("coarse", "fine"):
        for k, v in ref.params[net].items():
            assert torch.equal(state.params[net][k], v), (net, k)
    for p, q in zip(state.opt_state.state.values(),
                    ref.opt_state.state.values()):
        assert torch.equal(p["exp_avg"], q["exp_avg"])
        assert torch.equal(p["exp_avg_sq"], q["exp_avg_sq"])
        assert float(p["step"]) == float(q["step"]) == 6.0


def test_multi_step_converts_the_state_and_replaces_its_window(cuda):
    """The eager trainer's Adam on the card is the plain one; the capture
    makes the state's capturable. A second state captures anew in the same
    closure (its window from the same start equals the first's), and the
    first state, called again, captures anew too."""
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_multi_train_step,
    )

    mcfg, rcfg, tcfg, images, poses, K = _multi_step_case(cuda, n_imp=0)
    a = create_train_state(0, mcfg, rcfg, tcfg, cuda)
    b = create_train_state(0, mcfg, rcfg, tcfg, cuda)
    group = a.opt_state.param_groups[0]
    assert not group["capturable"] and isinstance(group["lr"], float)
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=2)
    multi(a, images, poses, K, 0)
    group = a.opt_state.param_groups[0]
    assert group["capturable"] and group["lr"].device.type == "cuda"
    multi(b, images, poses, K, 0)
    torch.cuda.synchronize()
    for k, v in a.params["coarse"].items():
        assert torch.equal(b.params["coarse"][k], v), k
    multi(a, images, poses, K, 0)
    multi(b, images, poses, K, 0)
    torch.cuda.synchronize()
    assert a.step == b.step == 4
    for k, v in a.params["coarse"].items():
        assert torch.equal(b.params["coarse"][k], v), k


def test_multi_step_replay_launches_the_window_kernels(cuda, tmp_path):
    """A replayed k = 2 window under device_trace: the graph launches K4,
    K5a and K5b 2k times each and K5's split sums 4k times (dW and db of
    each K5), all through no wrapper."""
    from torch.autograd import DeviceType

    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_multi_train_step,
    )
    from nerfail_tpu_torch.utils import profiling as prof

    mcfg, rcfg, tcfg, images, poses, K = _multi_step_case(cuda)
    k = 2
    state = create_train_state(0, mcfg, rcfg, tcfg, cuda)
    multi = make_multi_train_step(mcfg, rcfg, tcfg, precrop=False, k=k)
    multi(state, images, poses, K, 5)                 # warm-up and capture
    before = _launches()
    with prof.device_trace(str(tmp_path)) as p:
        multi(state, images, poses, K, 5)
        torch.cuda.synchronize()
    assert not any(_since(before).values())
    names = ("mlp_fwd_ws_kernel", "mlp_bwd_pass_kernel", "mlp_wgrad_kernel",
             "reduce_parts_kernel")
    kernels = [e for e in p.key_averages()
               if e.device_type == DeviceType.CUDA]
    counts = {n: sum(e.count for e in kernels if n in e.key) for n in names}
    assert counts == {"mlp_fwd_ws_kernel": 2 * k,
                      "mlp_bwd_pass_kernel": 2 * k,
                      "mlp_wgrad_kernel": 2 * k,
                      "reduce_parts_kernel": 4 * k}, counts


def test_profiling_on_the_card(cuda, tmp_path):
    """timed by CUDA events, the allocator's counters, a trace with
    device activity, and the roofline against the card's listed peaks."""
    from nerfail_tpu_torch.utils import profiling as prof

    a = torch.randn(2048, 2048, device=cuda, dtype=torch.bfloat16)
    secs = prof.timed(lambda: a @ a, iters=5)
    assert secs > 0
    mem = prof.device_memory_gb(cuda)
    assert mem["peak_allocated_gb"] > 0 and "allocated_bytes.all.current" in mem
    with prof.device_trace(str(tmp_path)) as p:
        a @ a
        prof.fence(a)
    assert os.path.exists(tmp_path / "trace.json")
    assert sum(e.self_device_time_total for e in p.key_averages()) > 0
    name = torch.cuda.get_device_name(cuda)
    if name in prof.PEAKS:
        r = prof.roofline(lambda x: x @ x, a, flops=2 * 2048 ** 3,
                          bytes_accessed=3 * 2 * 2048 ** 2)
        assert r.bound == "operations" and 0 < r.flops_utilization <= 1.0
    else:
        with pytest.raises(KeyError):
            prof.card_peaks(cuda)


def test_spans_on_the_card(cuda, tmp_path):
    """The program's spans from train_nerf, nerfail_s_attack (plan cache
    streaming) and extract_coord_maps on the card, under device_trace:
    every span's device_ms is above 0, and its children's sum to no more
    than its own (1e-3 ms for the float32 milliseconds of
    cudaEventElapsedTime). The attack's 3 batches classify and resize
    their clean views in epoch 0 only: epoch 1's steps reuse the clean
    logits and record one `attack.classify` and one `attack.resize`."""
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import (
        AttackConfig, ExperimentConfig, NeRFModelConfig, RenderConfig,
        TrainConfig,
    )
    from nerfail_tpu_torch.data.blender import white_background_composite
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.pointset.extract import extract_coord_maps
    from nerfail_tpu_torch.train.nerf_trainer import train_nerf
    from nerfail_tpu_torch.utils import profiling as prof
    from nerfail_tpu_torch.utils.device_cache import DeviceBudgetCache

    cfg = ExperimentConfig(
        model=NeRFModelConfig(netdepth=2, netwidth=64, skips=(0,)),
        render=RenderConfig(N_samples=16, N_importance=16, chunk=100),
        train=TrainConfig(N_rand=256, precrop_iters=0, i_print=1))
    scene = make_box_scene(n_train=4, n_val=1, n_test=1, H=16, W=16)
    targets = white_background_composite(scene.images)
    rng = np.random.default_rng(0)
    n, H, p, C = 6, 32, 2, 4
    w = rng.uniform(0, 1, (n, H, H, 8)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    idx = rng.integers(0, p * H * H, (n, H, H, 8)).astype(np.int32)
    ori = np.zeros((n, H, H, 4), np.float32)
    ori[..., :3] = rng.uniform(0, 255, (n, H, H, 3))
    ori[..., 3] = np.where(rng.uniform(size=(n, H, H)) > 0.3, 255.0, 0.0)
    delta0 = np.zeros((p, H, H, 4), np.float32)
    delta0[..., 3] = 255.0
    Wc = torch.randn(16 * 16 * 3, C, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0)) * 0.01
    logits_fn = lambda x: x.reshape(x.shape[0], -1) @ Wc  # noqa: E731
    with prof.device_trace(str(tmp_path)):
        state = train_nerf(cfg, targets, scene.poses, scene.K,
                           scene.i_train, n_iters=3, device=cuda)
        nerfail_s_attack(delta0, w, idx, ori, np.zeros(n, np.int64),
                         logits_fn, AttackConfig(eps=16.0, a=2.0,
                                                 batch_size=2),
                         resize_to=16, epochs=2,
                         plan_cache=DeviceBudgetCache(0, device=cuda),
                         device=cuda)
        extract_coord_maps(state.params, cfg, scene.poses[:2], 16, 16,
                           scene.K)
    rec = prof.trace_record()
    names = {s["name"] for s in rec["spans"]}
    assert {"train.step", "train.adam", "attack.step", "attack.plan",
            "attack.classify_backward", "render.view",
            "render.to_host"} <= names
    assert rec["counters"]["plan_cache.streamed_gets"] == 3
    assert rec["counters"]["attack.clean_logits_computed"] == 3
    assert rec["counters"]["attack.clean_logits_reused"] == 3
    spans = rec["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "attack.step"]
    per_step = {i: {"attack.classify": 0, "attack.resize": 0}
                for i in steps}
    for s in spans:
        if s["name"] in ("attack.classify", "attack.resize"):
            forward = spans[s["parent"]]
            assert forward["name"] == "attack.forward"
            per_step[forward["parent"]][s["name"]] += 1
    assert [per_step[i]["attack.classify"] for i in steps] == [2] * 3 + [1] * 3
    assert [per_step[i]["attack.resize"] for i in steps] == [2] * 3 + [1] * 3
    kids = {}
    for s in rec["spans"]:
        assert s["device_ms"] > 0, s
        if s["parent"] is not None:
            kids[s["parent"]] = kids.get(s["parent"], 0.0) + s["device_ms"]
    for i, total in kids.items():
        assert total <= rec["spans"][i]["device_ms"] + 1e-3, (
            rec["spans"][i], total)


def test_import_and_annotate_on_the_card(cuda, tmp_path):
    """torch_import into a model on the card (its logits against the same
    import on the CPU, within 1e-3 of the largest), and evaluate_testset's
    annotated dump from CUDA logits."""
    from nerfail_tpu_torch.eval.harness import evaluate_testset
    from nerfail_tpu_torch.models.classifiers.simple_cnn import MyCNN
    from nerfail_tpu_torch.models.classifiers.torch_import import (
        import_torch_state, torch_tensor_shapes,
    )
    from nerfail_tpu_torch.utils.png import imread

    rng = np.random.default_rng(11)
    seq = torch_tensor_shapes(MyCNN(num_classes=8).to(cuda))
    tensors = [rng.normal(0, 0.05, s).astype(np.float32) for _, s in seq]
    on_card = import_torch_state(MyCNN(num_classes=8).to(cuda).eval(),
                                 tensors)
    on_cpu = import_torch_state(MyCNN(num_classes=8).eval(), tensors)
    x = rng.uniform(0, 255, (2, 800, 800, 3)).astype(np.float32)
    with torch.no_grad():
        got = on_card(torch.from_numpy(x).to(cuda)).cpu()
        want = on_cpu(torch.from_numpy(x))
    assert float((got - want).abs().max()) <= 1e-3 * float(want.abs().max())
    out = evaluate_testset(on_card, x, np.array([0, 0]), attacked_class=0,
                           annotate_dir=str(tmp_path / "ann"), device=cuda)
    assert "asr" in out
    assert sorted(os.listdir(tmp_path / "ann")) == ["r_0.png", "r_1.png"]
    assert imread(str(tmp_path / "ann" / "r_0.png")).shape == (800, 800, 3)


def test_cli_commands_launch_on_the_card(tmp_path, capsys, cuda):
    """Every CLI command at 16² with --device cuda, in the order the
    reference's README runs them (4 + 2 + 128 views, so that the mask
    views 50, 75 and 125 exist; a 2×32 NeRF, one chunk of rays a view),
    with the kernels each launches: train-nerf K4 and K5 twice a step;
    extract-coords and render-only K4 twice a view; attack (NeRFail-S)
    K3 once a view, K4 for the coordinate maps and K1 for its steps;
    inherit K5 twice a retraining step and K4 for those steps and its
    renders; invert-disturbance, train-classifier and evaluate none. The
    artifacts the CPU run does not check: finite coordinate maps, the
    attack's e_max within ε, inherit's attacked train views and step-1
    renders of every view at half size (render_factor 2)."""
    import json

    from nerfail_tpu_torch.cli import main
    from nerfail_tpu_torch.config import SCENE_CLASSES, AttackConfig
    from nerfail_tpu_torch.data.synthetic import (
        make_box_scene, write_blender_format,
    )
    from nerfail_tpu_torch.pipeline import ArtifactLayout
    from nerfail_tpu_torch.utils.png import imread

    H, views = 16, (4, 2, 128)
    n_all = sum(views)
    write_blender_format(make_box_scene(*views, H=H, W=H, seed=0),
                         str(tmp_path / "lego"))
    for ci, cls in enumerate(SCENE_CLASSES):
        write_blender_format(make_box_scene(2, 1, 1, H=H, W=H, seed=ci,
                                            variant=ci),
                             str(tmp_path / "classes" / cls))
    (tmp_path / "cfg.txt").write_text(
        f"expname = lego\ndatadir = {tmp_path / 'lego'}\n"
        "dataset_type = blender\ntestskip = 1\nnetdepth = 2\n"
        "netwidth = 32\nmultires = 4\nmultires_views = 2\nN_samples = 8\n"
        "N_importance = 8\nN_rand = 64\nchunk = 8192\nprecrop_iters = 5\n"
        "i_print = 1000000\ni_weights = 1000000\n")
    com = ["--config", str(tmp_path / "cfg.txt"), "--output",
           str(tmp_path / "out"), "--device", "cuda"]
    atk = ["--method", "NeRFail_S", "--label", "lego", "--model_name",
           "simple_cnn", "--attack_epochs", "1"]
    commands = [
        ("train-nerf", [*com, "--n_iters", "10"]),
        ("extract-coords", com),
        ("render-only", com),
        ("invert-disturbance", [
            "--input", str(tmp_path / "lego" / "test" / "r_0.png"),
            "--out", str(tmp_path / "inv.png")]),
        ("train-classifier", [*com, "--model_name", "simple_cnn",
                              "--datadir", str(tmp_path / "classes"),
                              "--epochs", "1", "--batch_size", "8"]),
        ("attack", [*com, *atk]),
        ("evaluate", [*com, *atk, "--step", "0"]),
        ("inherit", [*com, *atk, "--render_factor", "2", "--n_iters", "5"]),
    ]
    got = {}
    for name, argv in commands:
        before = _launches()
        main([name, *argv])
        got[name] = _since(before)
    capsys.readouterr()
    lay = ArtifactLayout(str(tmp_path / "out"))
    coords = np.load(os.path.join(lay.coords_dir("lego"), "coords.npz"))
    assert coords["coords"].shape == (n_all, H, H, 3)
    assert np.isfinite(coords["coords"]).all()
    acfg = AttackConfig(method="NeRFail_S", attack_epochs=1)
    step0 = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg)
    with open(lay.eval_report_path(step0, "test")) as f:
        assert json.load(f)["e_max"] <= acfg.eps + 1e-3
    assert len(os.listdir(os.path.join(step0, "train"))) == 2 * views[0]
    step1 = lay.attack_dir("simple_cnn", "lego", "NeRFail_S", acfg, step=1)
    assert [len(os.listdir(os.path.join(step1, split)))
            for split in ("train", "val", "test")] == list(views)
    assert imread(os.path.join(step1, "test", "000.png")).shape == \
        (H // 2, H // 2, 3)
    none = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    assert got["train-nerf"] == {**none, "K4": 20, "K5": 20}
    assert got["extract-coords"] == {**none, "K4": 2 * n_all}
    assert got["render-only"] == {**none, "K4": 2 * n_all}
    for name in ("invert-disturbance", "train-classifier", "evaluate"):
        assert got[name] == none, (name, got[name])
    a = got["attack"]
    assert a["K3"] == n_all and a["K4"] > 0 and a["K1"] > 0
    assert a["K2"] == a["K5"] == 0
    i = got["inherit"]
    assert i["K5"] == 2 * 5 and i["K4"] > 2 * 5
    assert i["K1"] == i["K2"] == 0


def _gloo_on_the_card(fn, tmp_path, args):
    from nerfail_tpu_torch.parallel.launch import spawn

    return spawn(fn, 2, backend="gloo", store_dir=str(tmp_path),
                 device_type="cuda", model_parallel=1, args=args)


def test_segment_sum_sharded_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """2 gloo ranks on cuda:0: K1 on each rank's views, then the
    all-reduce; within K1's fp32 bound of the plain sum over all views,
    and the same on both ranks."""
    from nerfail_tpu_torch.tools import parallel_checks as pc

    rng = np.random.default_rng(3)
    V, HW, C, M = 4, 4096, 4, 6000
    g = rng.normal(size=(V, HW, C)).astype(np.float32)
    idx = rng.integers(0, M, (V, HW, 8)).astype(np.int32)
    w = rng.uniform(size=(V, HW, 8)).astype(np.float32)
    out = _gloo_on_the_card(pc.segment_sum_sharded_run, tmp_path,
                            (g, idx, w, M))
    gt = torch.from_numpy(g).reshape(-1, C)
    plan = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M)
    ref = segment_sum_plain(gt, plan)
    bound = error_bound(gt, plan)
    got = torch.from_numpy(out[0][True])
    assert bool(((got - ref).abs() <= 2 * bound + 1e-6).all())
    np.testing.assert_array_equal(out[0][True], out[1][True])


def test_sharded_nerfail_s_step_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """One make_nerfail_s_step over 2 gloo ranks on cuda:0 (each rank's
    views through K1, the gradient all-reduced): δ bit-equal across the
    ranks and at most 1 % of its RGB entries off one process's step on
    the card (sign ties of the summed gradient)."""
    from nerfail_tpu_torch.attacks.nerfail_s import make_nerfail_s_step
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.tools import parallel_checks as pc

    rng = np.random.default_rng(0)
    n, H, p, ncls = 4, 32, 2, 4
    w = rng.uniform(0, 1, (n, H, H, 8)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    idx = rng.integers(0, p * H * H, (n, H, H, 8)).astype(np.int32)
    ori = np.zeros((n, H, H, 4), np.float32)
    ori[..., :3] = rng.uniform(0, 255, (n, H, H, 3))
    ori[..., 3] = 255.0
    Wc = (rng.standard_normal((H * H * 3, ncls)) * 0.01).astype(np.float32)
    labels = np.arange(n) % ncls
    d0 = np.concatenate([np.zeros((p, H, H, 3), np.float32),
                         np.full((p, H, H, 1), 255.0, np.float32)], -1)
    cfg = dict(eps=16.0, a=2.0, batch_size=n)
    out = _gloo_on_the_card(pc.nerfail_s_step_run, tmp_path,
                            (d0, w, idx, ori, labels, Wc, cfg))
    np.testing.assert_array_equal(out[0]["delta"], out[1]["delta"])
    dev = torch.device("cuda")
    step = make_nerfail_s_step(pc.linear_logits_fn(Wc, dev),
                               AttackConfig(**cfg), None)
    wt, it, ot = (torch.as_tensor(a, device=dev) for a in (w, idx, ori))
    plan = build_csr_plan(it, wt, p * H * H, pair_mask=ot[..., 3:] > 0)
    d = torch.as_tensor(d0, device=dev)
    new, _ = step(d, d, wt, it, ot, torch.as_tensor(labels, device=dev),
                  torch.ones(n, device=dev), plan)
    flipped = np.mean(new.cpu().numpy()[..., :3]
                      != out[0]["delta"][..., :3])
    assert flipped <= 0.01
    assert np.abs(out[0]["delta"][..., :3]).max() > 0


@contextlib.contextmanager
def _world_of_one(backend, tmp_path):
    """A process group of this process alone, met on a FileStore, and its
    (1, 1) mesh on the current card."""
    import torch.distributed as dist

    from nerfail_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group(
        backend, store=dist.FileStore(str(tmp_path / f"{backend}.store"), 1),
        rank=0, world_size=1)
    try:
        yield make_mesh(1, 1, device=torch.device(
            "cuda", torch.cuda.current_device()))
    finally:
        dist.destroy_process_group()


def test_captured_window_over_gloo_raises_on_the_card(cuda, tmp_path):
    """gloo's collectives cannot run inside a CUDA graph, so
    make_multi_train_step on a gloo mesh on the card raises."""
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, make_multi_train_step, shard_train_state,
    )

    mcfg, rcfg, tcfg, images, poses, K = _multi_step_case(cuda)
    with _world_of_one("gloo", tmp_path) as mesh:
        assert mesh.backend == "gloo"
        state = shard_train_state(mesh, create_train_state(
            0, mcfg, rcfg, tcfg, cuda))
        multi = make_multi_train_step(mcfg, rcfg, tcfg, False, 2, mesh=mesh)
        with pytest.raises(RuntimeError, match="NCCL"):
            multi(state, images, poses, K, 0)


def test_nccl_world_of_one_rank_on_the_card(cuda, tmp_path):
    """An NCCL world of one rank: NeRFail-S and NeRFail on its mesh give
    the single-process runs' histories and δ bit for bit (the same sums),
    with K1 once a NeRFail-S step and K1 and K2 once a DeepFool iteration;
    a captured make_multi_train_step window of k = 3 steps, its
    all-reduce in the graph, bit-equal to 3 eager sharded steps of the
    same capturable Adam on the same draws, K4 and K5 twice an eager
    step and 2 + 2k times by the window's warm-up step and capture."""
    from nerfail_tpu_torch.attacks.nerfail import nerfail_attack
    from nerfail_tpu_torch.attacks.nerfail_s import nerfail_s_attack
    from nerfail_tpu_torch.config import AttackConfig
    from nerfail_tpu_torch.train.nerf_trainer import (
        create_train_state, gather_train_state, make_capturable,
        make_multi_train_step, make_train_step, sample_rays,
        shard_train_state, step_seed,
    )

    sc = _scene32()
    logits_fn = _linear_logits(sc, cuda)
    args = (sc["delta0"], sc["w"], sc["idx"], sc["ori"])
    cfg_s = AttackConfig(eps=32.0, a=2.0, batch_size=4)
    cfg_n = AttackConfig(eps=32.0, m1=2.0, m2=100.0, df_max_iter=20,
                         view_batch=3)
    labels = np.zeros(6, np.int64)
    single = {
        "s": nerfail_s_attack(*args, labels, logits_fn, cfg_s,
                              resize_to=None, epochs=2, device=cuda),
        "n": nerfail_attack(*args, logits_fn, cfg_n, resize_to=None,
                            epochs=3, device=cuda)}
    mcfg, rcfg, tcfg, images, poses, K = _multi_step_case(cuda)
    k = 3
    with _world_of_one("nccl", tmp_path) as mesh:
        assert mesh.backend == "nccl" and mesh.size == 1
        before = _launches()
        sharded_s = nerfail_s_attack(*args, labels, logits_fn, cfg_s,
                                     resize_to=None, epochs=2, mesh=mesh)
        launched_s = _since(before)
        before = _launches()
        sharded_n = nerfail_attack(*args, logits_fn, cfg_n, resize_to=None,
                                   epochs=3, mesh=mesh)
        launched_n = _since(before)

        ref = shard_train_state(mesh, create_train_state(0, mcfg, rcfg, tcfg,
                                                         cuda))
        make_capturable(ref.opt_state)
        step = make_train_step(mcfg, rcfg, tcfg, mesh=mesh)
        gen = torch.Generator(device=cuda)
        before = _launches()
        for i in range(k):
            gen.manual_seed(step_seed(5, i))
            batch = sample_rays(gen, images, poses, K, tcfg.N_rand, False,
                                tcfg.precrop_frac, tcfg.no_batching)
            step(ref, batch, gen, (16, 16), 0.0)
        eager = _since(before)
        state = shard_train_state(mesh, create_train_state(
            0, mcfg, rcfg, tcfg, cuda))
        before = _launches()
        make_multi_train_step(mcfg, rcfg, tcfg, False, k, mesh=mesh)(
            state, images, poses, K, 5)
        window = _since(before)
        got = gather_train_state(mesh, state).params
        want = gather_train_state(mesh, ref).params
    for run, key, keys in ((sharded_s, "s", ("epoch", "attack_acc",
                                              "clean_acc")),
                           (sharded_n, "n", ("epoch", "m1", "m2",
                                             "attack_acc",
                                             "deepfool_calls"))):
        assert [{x: h[x] for x in keys} for h in run.history] == \
            [{x: h[x] for x in keys} for h in single[key].history], key
        np.testing.assert_array_equal(run.delta, single[key].delta)
    none = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    assert launched_s == {**none, "K1": 2 * 2}
    loops = _deepfool_loops(sharded_n.history, cfg_n.df_max_iter)
    assert loops > 0 and launched_n == {**none, "K1": loops, "K2": loops}
    assert eager == {**none, "K4": 2 * k, "K5": 2 * k}
    assert window == {**none, "K4": 2 + 2 * k, "K5": 2 + 2 * k}
    for net in ("coarse", "fine"):
        for name, v in want[net].items():
            assert torch.equal(got[net][name], v), (net, name)
