"""PyTorch port, K1/K2: the plan's launch order and the DeepFool pick that
reads one class of the class stack in place.

Plans list their rows in plan-row order in `launch_rows`, the kernels'
table; `tools/segsum_order.py`'s `morton_order` is held to a numpy Morton
sort written out here, and a reordered plan's `launch_rows` to the order
it lists. K1's plain version on the plan stored in Morton order must be
bit-equal to the plain version on the plan as built (each row's pairs
keep their order); K2's plain version within `sq_error_bound`. Against the JAX package
(Pallas in interpret mode), the tolerances of tests/test_torch_segsum.py:
rtol 1e-5, atol 1e-4 for K1's sums and rtol 1e-5 for K2's squared norms;
the pick against the JAX engine's `pick` at rtol 1e-4, atol 1e-8, as
tests/test_torch_deepfool.py holds the engine.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nerfail_tpu_torch.ops.cuda.segsum_kernel import (  # noqa: E402
    build_batched_csr_plan, build_csr_plan, class_rows, segment_sq_plain,
    segment_sum, segment_sum_class, segment_sum_class_plain,
    segment_sum_plain, sq_error_bound,
)
from tools.segsum_order import (  # noqa: E402
    morton_order, pixel_morton, reordered, stored_in_launch_order,
)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _tables(seed, M, V, H, W, k=8):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, M, (V, H, W, k)).astype(np.int32)
    w = rng.uniform(0, 1, (V, H, W, k)).astype(np.float32)
    mask = rng.uniform(size=(V, H, W, 1)) > 0.4
    return idx, w, mask


def _plan(idx, w, M, mask):
    return build_batched_csr_plan(torch.from_numpy(idx), torch.from_numpy(w),
                                  M, pair_mask=torch.from_numpy(mask))


def _morton_np(y: int, x: int) -> int:
    code = 0
    for b in range(20):
        code |= ((x >> b) & 1) << (2 * b) | ((y >> b) & 1) << (2 * b + 1)
    return code


@pytest.mark.parametrize("shape", [(3, 8, 8), (2, 5, 12), (1, 16, 3)])
def test_morton_order_sorts_each_views_rows(shape):
    V, H, W = shape
    M = 150
    idx, w, mask = _tables(sum(shape), M, V, H, W)
    built = _plan(idx, w, M, mask)
    rp, pix = built.row_ptr.numpy(), built.pix.numpy()
    vp = built.view_ptr.numpy()
    views = np.searchsorted(vp, np.arange(built.n_rows), side="right") - 1
    np.testing.assert_array_equal(                 # plan-row order as built
        built.launch_rows.numpy(),
        np.stack([rp[:-1], rp[1:], built.rows.numpy(), views], 1))
    zorder = morton_order(built, W)
    plan = reordered(built, zorder)
    order = zorder.numpy()
    assert zorder.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(plan.n_rows))
    want = []
    for v in range(V):
        keys = []
        for r in range(vp[v], vp[v + 1]):
            first = int(pix[rp[r]:rp[r + 1]].min()) - v * H * W
            assert 0 <= first < H * W
            keys.append((_morton_np(first // W, first % W), r))
        want += [r for _, r in sorted(keys)]
    np.testing.assert_array_equal(order, want)
    for v in range(V):                       # stays inside the view's range
        part = order[vp[v]:vp[v + 1]]
        assert ((part >= vp[v]) & (part < vp[v + 1])).all()
    lr = plan.launch_rows.numpy()            # the kernels' table of it
    assert lr.shape == (plan.n_rows, 4) and lr.dtype == np.int32
    np.testing.assert_array_equal(lr[:, 0], rp[order])
    np.testing.assert_array_equal(lr[:, 1], rp[order + 1])
    np.testing.assert_array_equal(lr[:, 2], plan.rows.numpy()[order])
    np.testing.assert_array_equal(lr[:, 3], views[order])
    y, x = np.divmod(np.arange(H * W), W)
    np.testing.assert_array_equal(
        pixel_morton(torch.arange(H * W), W).numpy(),
        [_morton_np(a, b) for a, b in zip(y, x)])


def test_shared_plan_orders_the_stacked_views():
    """On build_csr_plan's plan (one point set shared by a batch of views)
    morton_order reads the batch as one table of the views stacked along
    y."""
    M, B, H, W = 120, 3, 6, 7
    idx, w, mask = _tables(5, M, B, H, W)
    plan = build_csr_plan(torch.from_numpy(idx), torch.from_numpy(w), M,
                          pair_mask=torch.from_numpy(mask))
    rp, pix = plan.row_ptr.numpy(), plan.pix.numpy()
    first = pix[rp[:-1]]
    keys = [(_morton_np(int(p) // W, int(p) % W), r)
            for r, p in enumerate(first)]
    np.testing.assert_array_equal(morton_order(plan, W).numpy(),
                                  [r for _, r in sorted(keys)])


@pytest.mark.parametrize("C", [4, 32])
def test_plain_k1_in_launch_order_is_bit_equal(C):
    """The plain K1 over the plan stored in Morton order equals the plain
    K1 over the plan as built, bit for bit, and both match the JAX
    package's planned_segment_sum_T."""
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan, local_leaves, padded_points,
        planned_segment_sum_T,
    )

    M, V, H, W = 300, 3, 8, 8
    idx, w, mask = _tables(20 + C, M, V, H, W)
    plan = _plan(idx, w, M, mask)
    zorder = morton_order(plan, W)
    walked = stored_in_launch_order(reordered(plan, zorder))
    assert walked.n_pairs == plan.n_pairs and walked.n_rows == plan.n_rows
    np.testing.assert_array_equal(
        walked.rows.numpy(), plan.rows.numpy()[zorder.numpy()])
    g = torch.from_numpy(np.random.default_rng(C).standard_normal(
        (V * H * W, C)).astype(np.float32))
    got = segment_sum_plain(g, walked)
    assert torch.equal(got, segment_sum_plain(g, plan))
    assert torch.equal(segment_sum(g, walked), got)

    jplan = build_batched_scatter_plan(idx, w, M, pair_mask=mask)
    leaves = tuple(jnp.asarray(a) for a in local_leaves(jplan.leaves()))
    want = np.asarray(planned_segment_sum_T(
        jnp.asarray(g.numpy().T), leaves, V * padded_points(M)))
    want = want.reshape(C, V, -1)[:, :, :M].transpose(1, 2, 0)
    np.testing.assert_allclose(got.numpy().reshape(V, M, C), want,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("C", [8, 32])
def test_plain_k2_in_launch_order_is_within_bound(C):
    """The plain K2 over the plan stored in Morton order against the plain
    K2 over the plan as built (within sq_error_bound) and against the JAX
    package's planned_segment_sq_T summed per view."""
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan, local_leaves, padded_points,
        planned_segment_sq_T,
    )

    M, V, H, W = 300, 2, 8, 8
    idx, w, mask = _tables(30 + C, M, V, H, W)
    plan = _plan(idx, w, M, mask)
    g = torch.from_numpy(np.random.default_rng(C + 1).standard_normal(
        (V * H * W, C)).astype(np.float32))
    want = segment_sq_plain(g, plan)
    got = segment_sq_plain(g, stored_in_launch_order(
        reordered(plan, morton_order(plan, W))))
    assert ((got - want).abs() <= sq_error_bound(g, plan)).all()

    jplan = build_batched_scatter_plan(idx, w, M, pair_mask=mask)
    leaves = tuple(jnp.asarray(a) for a in local_leaves(jplan.leaves()))
    jsq = np.asarray(planned_segment_sq_T(
        jnp.asarray(g.numpy().T), leaves, V * padded_points(M)))
    np.testing.assert_allclose(got.numpy(), jsq.reshape(V, -1, C).sum(1),
                               rtol=1e-5)


@pytest.mark.parametrize("C", [4, 8])
def test_class_pick_plain_is_k1_on_the_gathered_class(C):
    """segment_sum_class on CPU tensors (its plain version) equals
    segment_sum_plain of each view's class copied out of the stack, bit
    for bit, and the JAX package's planned_segment_sum_T on that class."""
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan, local_leaves, padded_points,
        planned_segment_sum_T,
    )

    M, V, H, W, ncls = 250, 3, 8, 8, 6
    idx, w, mask = _tables(40 + C, M, V, H, W)
    plan = _plan(idx, w, M, mask)
    rng = np.random.default_rng(C)
    stack = rng.standard_normal((V, H * W, ncls, C)).astype(np.float32)
    cls = np.array([4, 0, 5])
    tstack = torch.from_numpy(stack.reshape(V * H * W, ncls * C))
    got = segment_sum_class(tstack, torch.from_numpy(cls), plan, C)
    gsel = stack[np.arange(V), :, cls].reshape(-1, C)
    assert torch.equal(class_rows(tstack, torch.from_numpy(cls), plan, C),
                       torch.from_numpy(gsel))
    assert torch.equal(got, segment_sum_plain(torch.from_numpy(gsel), plan))
    assert torch.equal(got, segment_sum_class_plain(
        tstack, torch.from_numpy(cls),
        stored_in_launch_order(reordered(plan, morton_order(plan, W))), C))

    jplan = build_batched_scatter_plan(idx, w, M, pair_mask=mask)
    leaves = tuple(jnp.asarray(a) for a in local_leaves(jplan.leaves()))
    want = np.asarray(planned_segment_sum_T(
        jnp.asarray(gsel.T), leaves, V * padded_points(M)))
    want = want.reshape(C, V, -1)[:, :, :M].transpose(1, 2, 0)
    np.testing.assert_allclose(got.numpy().reshape(V, M, C), want,
                               rtol=1e-5, atol=1e-4)


def test_class_pick_matches_the_jax_engine_pick():
    """The port's pick, read out of its own engine's class stack
    (`deepfool_cotangents`), against the JAX engine's pick on the linear
    toy of tests/test_torch_deepfool.py."""
    from nerfail_tpu.attacks.forward import (
        composite_after_splat as j_comp, resize_batch as j_resize,
    )
    from nerfail_tpu.ops.pallas.segsum_kernel import (
        build_batched_scatter_plan,
    )
    from nerfail_tpu.ops.splat import splat_deepfool_engine as j_engine

    from nerfail_tpu_torch.attacks.forward import (
        composite_after_splat, resize_batch,
    )
    from nerfail_tpu_torch.ops.splat import (
        deepfool_cotangents, splat_forward_batched,
    )

    H = W = 8
    ncls, V, M = 4, 2, 2 * H * W
    rng = np.random.default_rng(1)
    weights = rng.uniform(0, 1, (V, H, W, 8)).astype(np.float32)
    weights /= weights.sum(-1, keepdims=True)
    idx = rng.integers(0, M, (V, H, W, 8)).astype(np.int32)
    ori = np.full((V, H, W, 4), 128.0, np.float32)
    ori[..., 3] = 255.0
    ori[:, 0, :3, 3] = 0.0
    Wc = rng.standard_normal((H * W * 3, ncls)).astype(np.float32) * 1e-2
    pts = np.zeros((V, M, 4), np.float32)
    pts[..., 3] = 255.0
    pts[..., :3] = rng.uniform(-20, 20, (V, M, 3))
    ori_label, k, eps = np.array([1, 3]), np.array([2, 0]), 32.0

    jplan = build_batched_scatter_plan(idx, weights, M,
                                       pair_mask=ori[..., 3:] > 0)
    ori_j = jnp.asarray(ori)

    def j_head(pix):
        x = j_resize(j_comp(pix, ori_j, eps=eps)["cla_x"], None)
        return x.reshape(x.shape[0], -1) @ jnp.asarray(Wc)

    _, _, jpick = j_engine(j_head, jnp.asarray(pts), jnp.asarray(idx),
                           jnp.asarray(weights), jplan, ncls,
                           jnp.asarray(ori_label))
    want = np.asarray(jpick(jnp.asarray(k)))

    ti, tw = torch.from_numpy(idx), torch.from_numpy(weights)
    ori_t = torch.from_numpy(ori)
    plan = build_batched_csr_plan(ti, tw, M, pair_mask=ori_t[..., 3:] > 0)
    tW = torch.from_numpy(Wc)

    def t_head(pix):
        x = resize_batch(composite_after_splat(pix, ori_t, eps=eps)["cla_x"],
                         None)
        return x.reshape(x.shape[0], -1) @ tW

    with torch.no_grad():
        pix = splat_forward_batched(torch.from_numpy(pts), ti, tw)
    _, G = deepfool_cotangents(t_head, pix, ncls, torch.from_numpy(ori_label))
    got = segment_sum_class(G, torch.from_numpy(k), plan).view(V, M, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-8)
    assert np.abs(want).max() > 0


def test_class_pick_rejects_what_it_cannot_take():
    M, V, H, W = 100, 2, 4, 4
    idx, w, mask = _tables(7, M, V, H, W)
    plan = _plan(idx, w, M, mask)
    stack = torch.zeros(V * H * W, 8 * 4)
    cls = torch.tensor([1, 2])
    segment_sum_class(stack, cls, plan)
    for s, c in ((stack[:, :30], cls), (stack[:-1], cls), (stack[0], cls),
                 (stack, cls.float()), (stack, cls[:1]),
                 (stack, torch.tensor([0, 8])), (stack, torch.tensor([-1, 0]))):
        with pytest.raises(ValueError):
            segment_sum_class(s, c, plan)
