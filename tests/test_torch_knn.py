"""PyTorch port, K3 module: exact k-NN tables against the JAX package.

Tolerances: the port's plain version and the Pallas kernel (interpret
mode) both form d² = (dx² + dy²) + dz² in f32 and take one sqrt, so
distances agree to rounding (rtol 1e-5, as tests/test_knn_kernel.py).
Indices are compared wherever the distance is not tied with a neighbour
in the sorted list (ties may resolve in either order: the kernel visits
tiles in candidate order, the brute force in index order).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from nerfail_tpu.ops.pallas import knn_kernel as JK  # noqa: E402
from nerfail_tpu_torch.ops.cuda import knn_kernel as TK  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _untied(q, p, k=8):
    """[Q, k] mask: the j-th neighbour's f32 d² differs from the (j-1)-th
    and the (j+1)-th of the full sorted list (the (k+1)-th included)."""
    d2 = (q[:, None, 0] - p[None, :, 0]) ** 2
    d2 = d2 + (q[:, None, 1] - p[None, :, 1]) ** 2
    d2 = d2 + (q[:, None, 2] - p[None, :, 2]) ** 2
    s = np.sort(d2, axis=1)[:, :k + 1]
    untied = np.ones((q.shape[0], k), bool)
    untied[:, 1:] &= s[:, 1:k] != s[:, :k - 1]
    untied &= s[:, :k] != s[:, 1:k + 1]
    return untied


def _data(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        q = rng.uniform(-1, 1, (257, 3))          # non-tile-multiple
        p = rng.uniform(-1, 1, (1000, 3))         # partial last tile
    else:                                         # clustered surface
        th, ph = rng.uniform(0, 2 * np.pi, 1500), rng.uniform(0, np.pi, 1500)
        p = np.stack([np.sin(ph) * np.cos(th), np.sin(ph) * np.sin(th),
                      np.cos(ph)], -1)
        q = p[:300] + rng.normal(0, 0.01, (300, 3))
    return q.astype(np.float32), p.astype(np.float32)


@pytest.mark.parametrize("kind", ["uniform", "surface"])
def test_plain_knn_matches_pallas_and_host_tree(kind):
    from nerfail_tpu.pointset.knn_build import knn_host_tree

    q, p = _data(kind, 5)
    d, i = TK.knn_plain(torch.from_numpy(q), torch.from_numpy(p), k=8,
                        q_chunk=100, p_tile=300)
    d, i = d.numpy(), i.numpy()
    jd, ji = JK.knn_pallas(q, p, k=8, tq=64, tp=128, interpret=True)
    hd, hi = knn_host_tree(q, p, k=8)
    ok = _untied(q, p)
    assert ok.mean() > 0.99
    for rd, ri in ((jd, ji), (hd, hi)):
        np.testing.assert_allclose(d, rd, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(i[ok], ri[ok])


@pytest.mark.parametrize("prune", [True, False])
def test_port_knn_on_cpu_matches_pallas(prune):
    """The wrapper on CPU tensors: the same Morton packing and
    un-permutation as on the card, with the plain version in the middle."""
    q, p = _data("surface", 6)
    d, i = TK.knn(q, p, k=8, tq=64, tp=128, prune=prune, device="cpu")
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    jd, ji = JK.knn_pallas(q, p, k=8, tq=64, tp=128, prune=prune,
                           interpret=True)
    ok = _untied(q, p)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(i.numpy()[ok], ji[ok])


def test_host_plan_arrays_bit_equal():
    """The port's plan, in torch ops on the CPU, against the JAX package's
    host numpy: Morton orders, packed points and queries and the tile
    bboxes bit-equal; each CSR row holds the JAX row's candidate set, in
    its order wherever the lower bound lb² differs (JAX sorts ties in no
    fixed order, the port by tile id); the same pair count."""
    rng = np.random.default_rng(9)
    p = np.concatenate([rng.uniform(-1, 1, (1500, 3)),
                        rng.uniform(-8, 8, (548, 3))]).astype(np.float32)
    q = np.concatenate([rng.uniform(-1, 1, (512, 3)),
                        rng.uniform(-8, 8, (200, 3))]).astype(np.float32)
    jprep = JK.KnnPrep(p, tp=128)
    tprep = TK.KnnPrep(p, tp=128, device="cpu")
    np.testing.assert_array_equal(tprep.pperm.numpy(), jprep.pperm)
    np.testing.assert_array_equal(tprep.ppk[:, :3].T.numpy(),
                                  np.asarray(jprep.ppk))
    assert (tprep.ppk[:, 3] == 0).all()
    np.testing.assert_array_equal(tprep.p_lo.numpy(), jprep.p_lo)
    np.testing.assert_array_equal(tprep.p_hi.numpy(), jprep.p_hi)
    jplan = JK.KnnQueryPlan(q, jprep, k=8, tq=64)
    tplan = TK.KnnQueryPlan(q, tprep, k=8, tq=64)
    np.testing.assert_array_equal(tplan.qperm.numpy(), jplan.qperm)
    np.testing.assert_array_equal(tplan.qpk.numpy(), jplan.qpk[:, :3])
    q_lo, q_hi = JK._tile_bboxes(jplan.qpk[:, :3], 64)
    gap = np.maximum(0.0, np.maximum(jprep.p_lo[None] - q_hi[:, None],
                                     q_lo[:, None] - jprep.p_hi[None]))
    lb2 = np.einsum("qpd,qpd->qp", gap, gap)
    row_ptr, tiles = tplan.row_ptr.numpy(), tplan.tiles.numpy()
    assert row_ptr.shape == (tplan.n_q + 1,) and row_ptr[-1] == tiles.size
    tied_rows = 0
    for r in range(tplan.n_q):
        jrow = jplan.cand[r][jplan.cand[r] >= 0]
        trow = tiles[row_ptr[r]:row_ptr[r + 1]]
        assert sorted(trow.tolist()) == sorted(jrow.tolist())
        lt, lj = lb2[r, trow], lb2[r, jrow]
        np.testing.assert_array_equal(lt, lj)          # both by lb² ascending
        assert np.all((np.diff(lt) > 0) | (np.diff(trow) > 0))   # ties by id
        unique = np.isin(lt, lt[np.r_[np.diff(lt) == 0, False]
                                | np.r_[False, np.diff(lt) == 0]],
                         invert=True)
        np.testing.assert_array_equal(trow[unique], jrow[unique])
        tied_rows += int((~unique).any())
    assert tied_rows > 0                     # the fixture has lb² ties
    assert tplan.max_c() == int((jplan.cand >= 0).sum(1).max())
    jc = jplan.cand[jplan.cand >= 0].tolist()
    assert tplan.pair_count() == sum(min(128, p.shape[0] - c * 128)
                                     for c in jc) * 64


def test_plan_cannot_be_combined_with_other_inputs():
    q, p = _data("uniform", 7)
    prep = TK.KnnPrep(p, tp=128, device="cpu")
    plan = TK.KnnQueryPlan(q, prep, tq=64)
    for kw in ({"queries": q}, {"points": p}, {"prep": prep}, {"k": 8}):
        with pytest.raises(ValueError, match="plan"):
            TK.knn(plan=plan, **kw)
    with pytest.raises(ValueError, match="OR"):
        TK.knn(q, p, prep=prep)
    d, i = TK.knn(plan=plan)
    jd, ji = JK.knn_pallas(q, p, k=8, tq=64, tp=128, interpret=True)
    np.testing.assert_allclose(d.numpy(), jd, rtol=1e-5, atol=1e-6)


def test_tables_match_jax_at_32():
    """build_index_and_dist + gauss_weights at 32²: the port's device
    method (plain on CPU) and host method against the JAX host method
    (exact KD-tree), and against the JAX CPU device method, whose
    |q|²+|p|²−2q·p expansion loses up to ~√(ulp(|q|²)) ≈ 1e-3 near d = 0
    (hence atol 3e-3 there)."""
    from nerfail_tpu.data.synthetic import analytic_coord_map, make_box_scene
    from nerfail_tpu.pointset.knn_build import build_index_and_dist as jb
    from nerfail_tpu.pointset.weights import gauss_weights as jg
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist
    from nerfail_tpu_torch.pointset.weights import gauss_weights

    H = 32
    sc = make_box_scene(n_train=5, n_val=0, n_test=0, H=H, W=H, seed=2)
    S = np.concatenate([analytic_coord_map(sc.poses[v], H, H, sc.K)
                        .reshape(-1, 3) for v in (0, 2)])
    c = 0.02 * 800 / H
    for v in (1, 3, 4):
        cm = analytic_coord_map(sc.poses[v], H, H, sc.K)
        hd, hi = jb(cm, S, k=8, method="host")
        dd, _ = jb(cm, jax.numpy.asarray(S), k=8, method="device")
        hw = np.asarray(jg(jax.numpy.asarray(hd), c=c))
        ok = _untied(cm.reshape(-1, 3), S).reshape(H, H, 8)
        for method in ("device", "host"):
            d, i = build_index_and_dist(cm, S, method=method, device="cpu")
            assert d.shape == (H, H, 8) and i.dtype == torch.int32
            np.testing.assert_allclose(d.numpy(), hd, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(i.numpy()[ok], hi[ok])
            w = gauss_weights(d, c=c).numpy()
            np.testing.assert_allclose(w, hw, rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(d.numpy(), dd, rtol=1e-4, atol=3e-3)
