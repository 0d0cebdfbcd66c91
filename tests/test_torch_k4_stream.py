"""K4's weight stream and tile schedule, on the CPU.

K4 (`mlp_fwd_ws_kernel` in nerfail_tpu_torch/csrc/nerf_mlp.cu) runs only on
the card; tests/test_torch_gpu.py holds it against `mlp_forward_plain`
there. What the kernel reads is built here in Python, so it is tested here:

- the packing: a numpy model of wgmma's 128-byte swizzle, written apart
  from `k4_stream_index`, unpacks the stream and gives back every element
  of the flat weights exactly once, with zeros in the padding;
- a plain walk that consumes the stream's slices in order, one K-slice per
  product, as the kernel's consumers do, reproduces `mlp_forward_plain`:
  to f32 rounding with MATMUL_DTYPE float32 (the same products summed in
  slices), and in bf16 layer 0 within the f32 summation bound of its
  operands and the output within 2 % of its largest entry (an activation
  whose f32 sum differs in its last bit can round to a bf16 one ulp away,
  and that travels through the later layers; the card's checks hold K4 to
  the same);
- the persistent schedule covers every 64-row half of the input once;
- the ring protocol (`k4_runs`, `k4_order`): at every width class and at
  the ring's stage count as `make_k4` plans it, in any interleaving of
  the two consumers, the walk of fills, issues and releases ends, every
  stage is refilled only after both consumers released it, and the
  leader stays within the ring; the same with the consumers in an
  enforced ping-pong order (measured slower on the card and not kept:
  PERF.md, Findings), whose turns alternate and never cross an epilogue;
  one stage, or a turn longer than the ring, stalls the walk.
"""

import random

import numpy as np
import pytest
import torch

from nerfail_tpu_torch.config import NeRFModelConfig
from nerfail_tpu_torch.ops.cuda import mlp_kernel as mk

_CFGS = {
    "8x256-skip4": dict(),
    "4x128": dict(netdepth=4, netwidth=128),
    "2x64": dict(netdepth=2, netwidth=64),
    "D1": dict(netdepth=1, netwidth=64, skips=()),
    "W96": dict(netdepth=3, netwidth=96, skips=(1,)),
    "W32": dict(netdepth=2, netwidth=32, skips=()),
    "skips-2-5": dict(netdepth=8, netwidth=128, skips=(2, 5)),
}


def _dims(name):
    return mk.MlpDims.from_cfg(NeRFModelConfig(**_CFGS[name]))


def _unswizzle(stage: np.ndarray, n: int) -> np.ndarray:
    """One stage [n rows of 128 bytes] → Wᵀ slice [n, 64]: the 16-byte
    chunk p of row c holds the row's logical chunk p ^ (c % 8)."""
    phys = stage.reshape(n, 8, 8)
    c = np.arange(n)[:, None]
    out = np.empty_like(phys)
    out[c, np.arange(8)[None, :] ^ (c % 8)] = phys
    return out.reshape(n, 64)


def _slices(image: np.ndarray, dims):
    """(stream entry, Wᵀ[:, k0:k0 + rows], Wᵀ's padding columns) per stage."""
    for entry in mk.k4_weight_stream(dims):
        _, _, _, rows, n, off = entry
        st = _unswizzle(image[off // 2:off // 2 + n * mk.SLICE], n)
        yield entry, st[:, :rows], st[:, rows:]


@pytest.mark.parametrize("name", list(_CFGS))
def test_stream_unpacks_to_every_weight_once(name):
    dims = _dims(name)
    shapes = dims.w_shapes()
    n_w = sum(k * n for k, n in shapes)
    w_off = np.cumsum([0] + [k * n for k, n in shapes])
    idx = mk.k4_stream_index(dims)
    seen = np.zeros(n_w, np.int64)
    for (j, _, k0, rows, n, _), src, pad in _slices(idx, dims):
        assert n == shapes[j][1] and k0 + rows <= shapes[j][0]
        assert (pad == n_w).all()                        # the zero sentinel
        want = w_off[j] + (k0 + np.arange(rows))[None, :] * n + np.arange(n)[:, None]
        assert (src == want).all()
        np.add.at(seen, src.reshape(-1), 1)
    assert (seen == 1).all()

    # the same through the packed bf16 values
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.standard_normal(n_w).astype(np.float32))
    image = mk.pack_stream(flat, dims).view(torch.int16).numpy()
    ref = flat.to(torch.bfloat16).view(torch.int16).numpy()
    for (j, _, k0, rows, n, _), got, pad in _slices(image, dims):
        assert (pad == 0).all()
        w = ref[w_off[j]:w_off[j + 1]].reshape(shapes[j])
        assert (got == w[k0:k0 + rows].T).all()


@pytest.mark.parametrize("name", list(_CFGS))
def test_stream_layout(name):
    """Stages are contiguous and 16-byte aligned (one bulk copy each), fit
    a ring slot of 128·W bytes, and each matrix's operands are cut at 64
    rows of their own."""
    dims = _dims(name)
    W = dims.width
    off = 0
    for j, operand, k0, rows, n, o in mk.k4_weight_stream(dims):
        assert o == off and o % 16 == 0 and 0 < rows <= mk.SLICE
        assert n * mk.SLICE * 2 <= 128 * W
        lo = dims.in_pad if (operand == "h" and j > 0 and (j - 1) in dims.skips) \
            else W if operand == "enc_d" else 0
        assert (k0 - lo) % mk.SLICE == 0
        off += n * mk.SLICE * 2
    assert off == 2 * len(mk.k4_stream_index(dims))


def _walk(xin, image, flat_b, dims):
    """The forward as K4's consumers run it: each product one K-slice of
    the stream at a time, in the stream's order."""
    D, W = dims.depth, dims.width
    bs = mk._split(flat_b, [(n,) for n in dims.b_sizes()])
    ops = {"enc_x": mk._r(mk._encode(xin, dims.multires, 0, dims.in_pad)[0]),
           "enc_d": mk._r(mk._encode(xin, dims.multires_views, 4,
                                     dims.vd_pad)[0])}
    stages = _slices(image, dims)

    def product(acc, parts):
        for operand, lo in parts:
            a = ops[operand]
            for k0 in range(0, a.shape[1], mk.SLICE):
                (_, name, sk0, rows, _, _), wt, _ = next(stages)
                assert name == operand and sk0 == lo + k0
                acc = acc + a[:, k0:k0 + rows] @ torch.from_numpy(wt.T.copy())
        return acc

    z0 = None
    for i in range(D):
        x_in = i == 0 or (i - 1) in dims.skips
        parts = ([("enc_x", 0)] if x_in else []) + (
            [("h", dims.in_pad if x_in else 0)] if i > 0 else [])
        z = product(torch.zeros(xin.shape[0], W), parts) + bs[i]
        z0 = z if i == 0 else z0
        ops["h"] = mk._r(torch.relu(z))
    ops["trunk"] = ops["h"]
    head = product(torch.zeros(xin.shape[0], mk.HEAD), [("trunk", 0)])
    ops["feature"] = mk._r(product(torch.zeros(xin.shape[0], W),
                                   [("trunk", 0)]) + bs[D])
    ops["hv"] = mk._r(torch.relu(product(torch.zeros(xin.shape[0], W // 2),
                                         [("feature", 0), ("enc_d", W)])
                                 + bs[D + 1]))
    head = product(head, [("hv", 0)])
    with pytest.raises(StopIteration):
        next(stages)
    return head[:, :4], z0


def _case(dims, n, seed):
    from nerfail_tpu_torch.models.nerf import init_nerf_params

    cfg = NeRFModelConfig(netdepth=dims.depth, netwidth=dims.width,
                          skips=dims.skips)
    params = init_nerf_params(torch.Generator().manual_seed(seed), cfg, "cpu")
    fw, fb = (t.detach().contiguous() for t in mk.pack_params(params, dims))
    rng = np.random.default_rng(seed + 1)
    pts = torch.from_numpy(rng.uniform(-2, 2, (n, 3)).astype(np.float32))
    vd = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32)), dim=-1)
    return mk.pack_input(pts, vd), fw, fb


@pytest.mark.parametrize("name", list(_CFGS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_walk_reproduces_the_plain_forward(name, dtype, monkeypatch):
    monkeypatch.setattr(mk, "MATMUL_DTYPE", getattr(torch, dtype))
    dims = _dims(name)
    xin, fw, fb = _case(dims, 128, 7)
    if dtype == "float32":
        # the f32 weights in the stream's order (the card's stream is bf16)
        image = torch.cat([fw, fw.new_zeros(1)])[
            torch.from_numpy(mk.k4_stream_index(dims))].numpy()
    else:
        image = mk.pack_stream(fw, dims).float().numpy()
    out, z0 = _walk(xin, image, fb, dims)
    ref = mk.mlp_forward_plain(xin, fw, fb, dims)
    z0_ref = mk.mlp_layer0_plain(xin, fw, fb, dims)
    assert out.shape == ref.shape == (xin.shape[0], 4)
    if dtype == "float32":
        torch.testing.assert_close(out, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        torch.testing.assert_close(z0, z0_ref, rtol=1e-5, atol=1e-6)
    else:
        enc = mk._r(mk._encode(xin, dims.multires, 0, dims.in_pad)[0])
        w0 = mk._r(fw[:dims.in_pad * dims.width].view(dims.in_pad, dims.width))
        bound = 2 * (dims.in_pad + 2) * 2.0 ** -23 * (enc.abs() @ w0.abs()
                                                       + fb[:dims.width].abs())
        assert bool(((z0 - z0_ref).abs() <= bound).all())
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= 0.02 * scale


@pytest.mark.parametrize("n", [64, 128, 192, 132 * 128 + 64, 2 ** 20])
def test_schedule_covers_every_half_once(n):
    sms = 132
    sched = mk.k4_schedule(n, sms)
    tiles = -(-n // mk.K4_TILE)
    grid = min(sms, tiles)
    rows = sorted(r for *_, r in sched)
    assert rows == list(range(0, n, 64))
    for blk, t, c, r in sched:
        assert 0 <= blk < grid and t % grid == blk
        assert r == t * mk.K4_TILE + 64 * c
    # the last tile holds 64 rows when n is an odd number of halves
    assert len(sched) == n // 64
    assert {blk for blk, *_ in sched} == set(range(grid))


_WIDTHS = {f"8x{w}": dict(netwidth=w) for w in range(32, 257, 32)}
_WIDTHS["8x256-3-stages"] = dict(multires=20)   # turns of 2 and 3 slices


def _runs(dims, tiles):
    """The slices between two epilogues of a consumer, per run, counted
    from the weight shapes: 64-row slices of each operand of a layer."""
    D, W, xp = dims.depth, dims.width, dims.in_pad
    sl = lambda k: -(-k // mk.SLICE)                     # noqa: E731
    layer = [sl(xp)] + [sl(W) + (sl(xp) if (i - 1) in dims.skips else 0)
                        for i in range(1, D)]
    # alpha + feature, views, rgb
    return tiles * (layer + [2 * sl(W), sl(W) + sl(dims.vd_pad), sl(W // 2)])


def _turns(runs, limit):
    """Each run cut into turns of at most `limit` slices, as even as can
    be, the longer first: the enforced ping-pong order, measured slower
    on the card and not kept."""
    out = []
    for rest in runs:
        while rest:
            k = -(-rest // limit)
            out.append(-(-rest // k))
            rest -= out[-1]
    return out


def _check_walk(events, runs, stages, turns=None):
    total = sum(runs)
    released = [set(), set()]
    issued = [[], []]
    passed = [0, 0]
    turn_of = None if turns is None else np.repeat(np.arange(len(turns)),
                                                   turns)
    for ev in events:
        kind = ev[0]
        if kind == "fill":
            _, stage, j = ev
            assert stage == j % stages
            if j >= stages:        # both consumers released its last slice
                assert all(j - stages in r for r in released)
        elif kind == "issue":
            _, a, j = ev
            if turns is not None:
                # consumer 0's turn t after consumer 1's turn t - 1,
                # consumer 1's turn t after consumer 0's turn t
                assert passed[1 - a] >= turn_of[j] + a
            # the leader within the ring: the oldest slice the other
            # consumer still holds lies less than a ring behind
            held = min(set(range(total + 1)) - released[1 - a])
            assert j - held < stages
            issued[a].append(j)
        elif kind == "release":
            released[ev[1]].add(ev[2])
        else:
            passed[ev[1]] += 1
    for a in (0, 1):                                    # the walk ended
        assert issued[a] == list(range(total))
        assert released[a] == set(range(total))
        assert passed[a] == (0 if turns is None else len(turns))
    assert sum(1 for ev in events if ev[0] == "fill") == total


_PICKS = [None] + [random.Random(seed).choice for seed in range(3)]


@pytest.mark.parametrize("name", list(_CFGS) + list(_WIDTHS))
@pytest.mark.parametrize("tiles", [1, 3])
def test_ring_protocol_walk(name, tiles):
    """The kernel's protocol: the consumers in any interleaving."""
    dims = mk.MlpDims.from_cfg(NeRFModelConfig(**{**_CFGS, **_WIDTHS}[name]))
    stages = mk.k4_stages(dims)
    assert 2 <= stages <= mk.K4_MAX_STAGES
    assert stages * 128 * dims.width <= mk.K4_SMEM_LIMIT
    runs = mk.k4_runs(dims, tiles)
    assert runs == _runs(dims, tiles)
    assert sum(runs) == tiles * len(mk.k4_weight_stream(dims))
    for pick in _PICKS:
        _check_walk(mk.k4_order(runs, stages, pick=pick), runs, stages)


@pytest.mark.parametrize("name", list(_CFGS) + list(_WIDTHS))
def test_ping_pong_order_walk(name):
    """The enforced ping-pong order, measured slower on the card and not
    kept: the consumers take turns of at most stages - 1 slices, which
    never cross an epilogue."""
    dims = mk.MlpDims.from_cfg(NeRFModelConfig(**{**_CFGS, **_WIDTHS}[name]))
    stages = mk.k4_stages(dims)
    runs = mk.k4_runs(dims, 3)
    turns = _turns(runs, stages - 1)
    assert set(np.cumsum(runs).tolist()) <= set(np.cumsum(turns).tolist())
    for pick in _PICKS:
        _check_walk(mk.k4_order(runs, stages, turns, pick), runs, stages,
                    turns)


@pytest.mark.parametrize("name", ["8x256-skip4", "8x128", "W32"])
def test_ring_protocol_walk_stalls_where_the_plan_forbids(name):
    """One stage, or a turn longer than the ring, stalls the walk: why
    `make_k4` asks for two stages and the ping-pong variant cuts turns."""
    dims = mk.MlpDims.from_cfg(NeRFModelConfig(**{**_CFGS, **_WIDTHS}[name]))
    runs = mk.k4_runs(dims, 2)
    with pytest.raises(RuntimeError, match="stalls"):
        mk.k4_order(runs, 1)
    turns = _turns(runs, mk.k4_stages(dims) - 1)
    with pytest.raises(RuntimeError, match="stalls"):
        mk.k4_order(runs, max(turns) - 1, turns)
