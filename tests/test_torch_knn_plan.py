"""PyTorch port, K3's split search on the CPU: work items and the planned
plain walk.

The CUDA search cuts each CSR row of the plan into items of at most C
candidate tiles and merges the items' top-8s stably. `knn_sq_planned_plain`
walks a plan the same way in plain PyTorch. Held here: the items cover
every row once, in scan order, and the split walk is bit-equal, d² and
indices, ties included, to one scan of each row for any C; its d² are
bit-equal to the brute force (same f32 arithmetic), indices equal where
the distance is not tied.
"""

import numpy as np
import pytest
import torch

from nerfail_tpu_torch.ops.cuda import knn_kernel as TK


def _clusters():
    """Points in two far clusters, every fifth point duplicated exactly,
    and queries near both, so the first query tile straddles the two
    (its bbox spans the gap, and it keeps almost every point tile) and
    many of the top-8 distances tie; a few queries sit on points (d = 0,
    tied with their duplicate)."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-0.2, 0.2, (150, 3))
    b = rng.uniform(-0.2, 0.2, (150, 3)) + 5.0
    p = np.concatenate([a, b, a[::5], b[::5]]).astype(np.float32)   # M = 360
    q = np.concatenate([a[:40] + rng.normal(0, 0.01, (40, 3)), p[:6],
                        b[:54] + rng.normal(0, 0.01, (54, 3))]).astype(np.float32)
    return q, p


def _one_scan(plan):
    """Each row's candidate points in slot order, one numpy stable sort
    of [8 × (inf, 0), d² in scan order] per query: the kernels' tie rule."""
    tq, tp, M, k = plan.tq, plan.prep.tp, plan.prep.M, plan.k
    qpk = plan.qpk.numpy()
    ppk = plan.prep.ppk.numpy()
    rp, tiles = plan.row_ptr.numpy(), plan.tiles.numpy()
    out_d = np.empty((plan.n_q * tq, k), np.float32)
    out_i = np.empty((plan.n_q * tq, k), np.int64)
    for r in range(plan.n_q):
        ids = np.concatenate([np.arange(t * tp, min(t * tp + tp, M))
                              for t in tiles[rp[r]:rp[r + 1]]])
        for j in range(r * tq, (r + 1) * tq):
            d = qpk[j] - ppk[ids, :3]
            d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            d2 = np.concatenate([np.full(k, np.inf, np.float32), d2])
            ii = np.concatenate([np.zeros(k, np.int64), ids])
            o = np.argsort(d2, kind="stable")[:k]
            out_d[j], out_i[j] = d2[o], ii[o]
    return out_d, out_i


@pytest.fixture(scope="module")
def plan():
    q, p = _clusters()
    prep = TK.KnnPrep(p, tp=32, device="cpu")
    return TK.KnnQueryPlan(q, prep, k=8, tq=64)


@pytest.mark.parametrize("C", [1, 3, "max_c"])
def test_planned_plain_split_equals_one_scan(plan, C):
    C = plan.max_c() if C == "max_c" else C
    assert plan.max_c() > 3 * 3          # the long row splits into ≥ 4 items
    d, i = TK.knn_sq_planned_plain(plan.qpk, plan.prep.ppk, plan, C)
    od, oi = _one_scan(plan)
    np.testing.assert_array_equal(d.numpy(), od)
    np.testing.assert_array_equal(i.numpy(), oi)
    # ties: d = 0 on a duplicated point, and tied distances in the top 8
    assert (od[:, 0] == 0).sum() >= 6 and (np.diff(od, axis=1) == 0).any()
    M = plan.prep.M
    bd, bi = TK.knn_sq_plain(plan.qpk, plan.prep.ppk[:M, :3], k=9)
    np.testing.assert_array_equal(d.numpy(), bd[:, :8].numpy())
    untied = np.ones(d.shape, bool)
    s = bd.numpy()
    untied[:, 1:] &= s[:, 1:8] != s[:, :7]
    untied &= s[:, :8] != s[:, 1:9]
    np.testing.assert_array_equal(i.numpy()[untied], bi[:, :8].numpy()[untied])


@pytest.mark.parametrize("C", [1, 3, 32])
def test_work_items_cover_each_row_once(plan, C):
    """Items partition every row's slots into runs of ≤ C in scan order,
    largest first; a row of one item writes the output (slot −1), the
    items of a split row own consecutive scratch slots in scan order, and
    `merges` lists exactly the split rows."""
    w = plan.work(C)
    items, merges = w.items.numpy(), w.merges.numpy()
    rp = plan.row_ptr.numpy()
    assert w.n_rows == plan.n_q and w.item_tiles == C
    assert np.all(np.diff(items[:, 2]) <= 0)
    seen = {}
    for row, first, count, slot in items.tolist():
        assert 0 <= count <= C
        seen.setdefault(row, []).append((first, count, slot))
    split = []
    for r in range(plan.n_q):
        runs = sorted(seen[r])
        n = rp[r + 1] - rp[r]
        assert len(runs) == max(1, -(-n // C))
        assert runs[0][0] == rp[r] and sum(c for _, c, _ in runs) == n
        for (f0, c0, _), (f1, _, _) in zip(runs, runs[1:]):
            assert f1 == f0 + c0 == f0 + C
        slots = [s for _, _, s in runs]
        if len(runs) == 1:
            assert slots == [-1]
        else:
            assert slots == list(range(slots[0], slots[0] + len(runs)))
            split.append([r, slots[0], len(runs)])
    assert merges.tolist() == split
    assert w.n_scratch == sum(n for _, _, n in split)


def test_knn_takes_tensor_queries_on_the_plans_device():
    """A coordinate map given as a tensor plans without a numpy copy and
    gives what the numpy map gives."""
    from nerfail_tpu_torch.pointset.knn_build import build_index_and_dist

    q, p = _clusters()
    cm = q[:96].reshape(8, 12, 3)
    got = build_index_and_dist(torch.from_numpy(cm), torch.from_numpy(p),
                               device="cpu")
    want = build_index_and_dist(cm, p, device="cpu")
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    prep = TK.KnnPrep(torch.from_numpy(p), tp=32, device="cpu")
    timings = {}
    d, i = TK.knn(torch.from_numpy(cm), prep=prep, tq=64, timings=timings)
    np.testing.assert_allclose(d.numpy(), want[0].reshape(-1, 8).numpy(),
                               rtol=1e-6)
    assert set(timings) == {"plan", "search"}
