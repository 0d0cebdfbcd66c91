"""PyTorch port, K1/K2 module: the splat backward's segmented reductions.

Tolerance rtol 1e-5, atol 1e-4 as tests/test_segsum_kernel.py: fp32 sums
of the same products in another order (the port sums pairs per point in
pixel order; segment_sum and the Pallas one-hot contraction in theirs).
The squared norms (K2) compare at rtol 1e-5: sums of nonnegative terms,
far from zero.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.ops.cuda.segsum_kernel import (  # noqa: E402
    build_batched_csr_plan, build_csr_plan, segment_sq, segment_sq_plain,
    segment_sum, segment_sum_plain, sq_error_bound,
)
from nerfail_tpu_torch.ops.splat import (  # noqa: E402
    splat_gather, splat_gather_batched,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tables(seed, M=700, B=2, H=16, W=16, k=8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, M, (B, H, W, k)).astype(np.int32)
    w = rng.uniform(0, 1, (B, H, W, k)).astype(np.float32)
    mask = rng.uniform(size=(B, H, W, 1)) > 0.5
    g = rng.standard_normal((B * H * W, 4)).astype(np.float32)
    return idx, w, mask, g


@pytest.mark.parametrize("masked", [False, True])
def test_plain_segment_sum_matches_jax(masked):
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_scatter_plan, local_leaves, planned_segment_sum,
    )

    M = 700
    idx, w, mask, g = _tables(1, M)
    pm = mask if masked else None
    plan = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M,
                          pair_mask=None if pm is None else
                          torch.from_numpy(pm))
    got = segment_sum(torch.from_numpy(g), plan).numpy()

    jplan = build_scatter_plan(idx, w, M, pair_mask=pm)
    leaves = tuple(jnp.asarray(a) for a in local_leaves(jplan.leaves()))
    want_pallas = np.asarray(planned_segment_sum(jnp.asarray(g), leaves, M))
    keep = (np.broadcast_to(pm, idx.shape) if masked
            else np.ones(idx.shape, bool)).reshape(-1)
    contrib = (w.reshape(-1, 8)[..., None] * g[:, None, :]).reshape(-1, 4)
    want_xla = np.asarray(jax.ops.segment_sum(
        jnp.asarray(contrib * keep[:, None]), jnp.asarray(idx.reshape(-1)),
        num_segments=M,
    ))
    assert plan.n_pairs == jplan.n_pairs == int(keep.sum())
    for want in (want_pallas, want_xla):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_plan_layout_is_csr_by_point_with_stable_pixels():
    M = 300
    idx, w, mask, _ = _tables(2, M, B=1, H=8, W=8)
    plan = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M,
                          pair_mask=torch.from_numpy(mask))
    rp, rows = plan.row_ptr.numpy(), plan.rows.numpy()
    assert plan.row_ptr.dtype == torch.int32 and plan.pix.dtype == torch.int32
    assert rp[0] == 0 and rp[-1] == plan.n_pairs and (np.diff(rp) > 0).all()
    flat_idx, pix, wv = idx.reshape(-1), plan.pix.numpy(), plan.w.numpy()
    keep = np.broadcast_to(mask, idx.shape).reshape(-1)
    kept = np.nonzero(keep)[0]
    np.testing.assert_array_equal(rows, np.unique(flat_idx[kept]))
    assert plan.n_views == 1 and plan.view_rows == (len(rows),)
    for r, m in enumerate(rows):
        seg = slice(rp[r], rp[r + 1])
        want = kept[flat_idx[kept] == m]          # pairs of m, in order
        np.testing.assert_array_equal(pix[seg], want // 8)
        np.testing.assert_array_equal(wv[seg], w.reshape(-1)[want])


def test_stale_or_wrong_plan_raises():
    M = 200
    idx, w, _, g = _tables(3, M, B=2, H=4, W=4)
    plan = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M)
    pts = torch.zeros(M, 4, requires_grad=True)
    with pytest.raises(ValueError, match="stale plan"):     # other batch
        splat_gather(pts, torch.from_numpy(idx[:1]), torch.from_numpy(w[:1]),
                     plan=plan)
    with pytest.raises(ValueError, match="stale plan"):     # other point set
        splat_gather(torch.zeros(M + 1, 4), torch.from_numpy(idx),
                     torch.from_numpy(w), plan=plan)
    with pytest.raises(ValueError, match="pixels"):
        segment_sum(torch.from_numpy(g[:-1]), plan)
    with pytest.raises(ValueError, match="out of range"):
        build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M - 50)


def test_empty_points_get_zero_rows():
    M = 50
    idx = torch.tensor([[3, 3, 7, 7, 7, 3, 3, 3]], dtype=torch.int32)
    w = torch.ones(1, 8)
    plan = build_csr_plan(idx, w, M)
    g = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    out = segment_sum(g, plan)
    want = torch.zeros(M, 4)
    want[3] = 5 * g[0]
    want[7] = 3 * g[0]
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    torch.testing.assert_close(segment_sum_plain(g, plan), want)


@pytest.mark.parametrize("masked", [False, True])
def test_splat_grad_matches_jax(masked):
    """d_points from the port's autograd splat (plain backward on CPU)
    against jax.grad through nerfail_tpu.ops.splat.splat_gather. With a
    masked plan the cotangent is zero on the dropped pixels, as the
    attack's composite makes it."""
    from nerfail_tpu.ops.splat import splat_gather as j_splat

    M = 600
    idx, w, mask, _ = _tables(4, M, B=2, H=8, W=8)
    rng = np.random.default_rng(5)
    pts = rng.standard_normal((M, 4)).astype(np.float32)
    G = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    if masked:
        G = G * mask

    def jloss(p):
        return jnp.sum(j_splat(p, jnp.asarray(idx), jnp.asarray(w))
                       * jnp.asarray(G))

    jout = np.asarray(j_splat(jnp.asarray(pts), jnp.asarray(idx),
                              jnp.asarray(w)))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))

    tp = torch.from_numpy(pts).requires_grad_(True)
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    plan = (build_csr_plan(ti, tw, M, pair_mask=torch.from_numpy(mask))
            if masked else None)
    out = splat_gather(tp, ti, tw, plan=plan)
    (grad,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(G)), tp)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-5, atol=1e-4)


def test_row_gather_is_a_bit_exact_copy():
    """The splat forward moves RGBA rows as one 16-byte element; it must
    equal index_select exactly, and fall back for rows it cannot view."""
    from nerfail_tpu_torch.ops.splat import _gather_rows

    rng = np.random.default_rng(7)
    base = torch.from_numpy(rng.standard_normal((401, 4)).astype(np.float32))
    flat = torch.from_numpy(rng.integers(0, 400, 999).astype(np.int32))
    for pts in (base, base[1:], base[:, :3]):     # fast path, offset, C=3
        torch.testing.assert_close(_gather_rows(pts, flat),
                                   pts.index_select(0, flat), rtol=0, atol=0)


def _jax_batched(idx, w, M, pm):
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan, local_leaves, padded_points,
    )

    jplan = build_batched_scatter_plan(idx, w, M, pair_mask=pm)
    leaves = tuple(jnp.asarray(a) for a in local_leaves(jplan.leaves()))
    return jplan, leaves, idx.shape[0] * padded_points(M)


@pytest.mark.parametrize("masked", [False, True])
def test_batched_plan_segment_sum_matches_jax(masked):
    """The batched plan plus K1's plain version against
    planned_segment_sum_T over build_batched_scatter_plan (Pallas in
    interpret mode), on the unpadded rows of each view."""
    from nerfail_tpu.ops.pallas.segsum_kernel import planned_segment_sum_T

    M, V, C = 300, 3, 8
    idx, w, mask, _ = _tables(8, M, B=V, H=8, W=8)
    g = np.random.default_rng(9).standard_normal((V * 64, C)).astype(
        np.float32)
    pm = mask if masked else None
    plan = build_batched_csr_plan(
        torch.from_numpy(idx), torch.from_numpy(w), M,
        pair_mask=None if pm is None else torch.from_numpy(pm))
    got = segment_sum(torch.from_numpy(g), plan).numpy().reshape(V, M, C)

    jplan, leaves, rows = _jax_batched(idx, w, M, pm)
    want = np.asarray(planned_segment_sum_T(jnp.asarray(g.T), leaves, rows))
    want = want.reshape(C, V, -1)[:, :, :M].transpose(1, 2, 0)
    assert plan.n_pairs == jplan.n_pairs
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C", [4, 32])
def test_segment_sq_plain_matches_jax(C):
    """K2's plain version per view against planned_segment_sq_T's
    per-chunk squared norms summed per view."""
    from nerfail_tpu.ops.pallas.segsum_kernel import planned_segment_sq_T

    M, V = 300, 2
    idx, w, mask, _ = _tables(10, M, B=V, H=8, W=8)
    g = np.random.default_rng(11).standard_normal((V * 64, C)).astype(
        np.float32)
    plan = build_batched_csr_plan(torch.from_numpy(idx), torch.from_numpy(w),
                                  M, pair_mask=torch.from_numpy(mask))
    tg = torch.from_numpy(g)
    got = segment_sq(tg, plan).numpy()
    np.testing.assert_array_equal(got, segment_sq_plain(tg, plan).numpy())

    _, leaves, rows = _jax_batched(idx, w, M, mask)
    want = np.asarray(planned_segment_sq_T(jnp.asarray(g.T), leaves, rows))
    want = want.reshape(V, -1, C).sum(1)
    assert got.shape == (V, C)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batched_plan_lists_touched_rows_by_view():
    M, V = 200, 3
    idx, w, mask, _ = _tables(12, M, B=V, H=4, W=4)
    idx[1] = idx[1] % 50                     # view 1 touches few rows
    plan = build_batched_csr_plan(torch.from_numpy(idx), torch.from_numpy(w),
                                  M, pair_mask=torch.from_numpy(mask))
    rows, rp = plan.rows.numpy(), plan.row_ptr.numpy()
    vp = plan.view_ptr.numpy()
    assert plan.num_points == V * M and plan.n_views == V
    assert (np.diff(rows) > 0).all() and (np.diff(rp) > 0).all()
    assert rp[0] == 0 and rp[-1] == plan.n_pairs
    assert vp[0] == 0 and vp[-1] == plan.n_rows
    assert plan.view_rows == tuple(np.diff(vp))
    keep = np.broadcast_to(mask, idx.shape).reshape(V, -1)
    flat = idx.reshape(V, -1)
    for v in range(V):
        touched = np.unique(flat[v][keep[v]]) + v * M
        np.testing.assert_array_equal(rows[vp[v]:vp[v + 1]], touched)
    pix = plan.pix.numpy()
    for r in range(plan.n_rows):             # pixel order within a row
        assert (np.diff(pix[rp[r]:rp[r + 1]]) >= 0).all()
    # the plan of a shared point set is the one-view case
    g = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (V * 16, 4)).astype(np.float32))
    shared = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M,
                            pair_mask=torch.from_numpy(mask))
    s = segment_sum(g, shared)
    torch.testing.assert_close(
        segment_sq(g, shared), (s.double() ** 2).sum(0, keepdim=True)
        .float(), rtol=1e-6, atol=0)


def test_sq_error_bound_is_tight_and_covers_float32_sums():
    """The bound covers a float32 sum of float32 squares in an order of
    its own, and stays far below the values it bounds."""
    M, V, C = 300, 2, 32
    idx, w, mask, _ = _tables(13, M, B=V, H=8, W=8)
    plan = build_batched_csr_plan(torch.from_numpy(idx), torch.from_numpy(w),
                                  M, pair_mask=torch.from_numpy(mask))
    g = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (V * 64, C)).astype(np.float32))
    s = segment_sum(g, plan).view(V, M, C)
    f32 = torch.flip(s * s, dims=[1]).sum(1)          # another order
    want = segment_sq_plain(g, plan)
    bound = sq_error_bound(g, plan)
    assert ((f32 - want).abs() <= bound).all()
    assert (bound < 1e-4 * want).all()


def test_splat_gather_batched_matches_jax():
    """Per-view splat forward and d_points_b through the batched plan
    against jax.grad through the JAX package's splat_gather_batched."""
    from nerfail_tpu.ops.splat import splat_gather_batched as j_splat

    M, V = 250, 2
    idx, w, mask, _ = _tables(15, M, B=V, H=8, W=8)
    rng = np.random.default_rng(16)
    pts = rng.standard_normal((V, M, 4)).astype(np.float32)
    G = rng.standard_normal((V, 8, 8, 4)).astype(np.float32) * mask

    def jloss(p):
        return jnp.sum(j_splat(p, jnp.asarray(idx), jnp.asarray(w))
                       * jnp.asarray(G))

    jout = np.asarray(j_splat(jnp.asarray(pts), jnp.asarray(idx),
                              jnp.asarray(w)))
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(pts)))
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    plan = build_batched_csr_plan(ti, tw, M, pair_mask=torch.from_numpy(mask))
    for p in (plan, None):
        tp = torch.from_numpy(pts).requires_grad_(True)
        out = splat_gather_batched(tp, ti, tw, plan=p)
        (grad,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(G)),
                                      tp)
        np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-5, atol=1e-4)
