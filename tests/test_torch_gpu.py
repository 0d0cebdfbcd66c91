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
to 2⁹, so its largest entries are cancellation residues).
"""

import dataclasses
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


# K4's persistent kernel at widths 32, 96, 128 and 256, at depth 1 and
# with skips (2, 5); each at a lone 64-row half tile, one and a half
# tiles, and (on a 132-SM card) three waves of tiles and a half
_K4_CFGS = {"W32": dict(netdepth=2, netwidth=32, skips=()),
            "W96": dict(netdepth=3, netwidth=96, skips=(1,)),
            "W128": dict(netdepth=4, netwidth=128),
            "W256": dict(),
            "D1": dict(netdepth=1, netwidth=64, skips=()),
            "skips-2-5": dict(netdepth=8, netwidth=128, skips=(2, 5))}


@pytest.mark.parametrize("name", list(_K4_CFGS))
@pytest.mark.parametrize("n", [64, 192, 132 * 128 * 3 + 64])
def test_k4_persistent_kernel_matches_plain(cuda, name, n):
    from nerfail_tpu_torch.config import NeRFModelConfig

    _check_k4(cuda, NeRFModelConfig(**_K4_CFGS[name]), n, 4)


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
    summed in other orders by cuDNN / cuBLAS and the CPU kernels)."""
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
        got = model.to(cuda)(x.to(cuda)).cpu()
    assert torch.isfinite(got).all()
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale


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
