"""K4 and K5: the fused NeRF encoding + MLP and its recompute backward.

K4 replaces nerfail_tpu/ops/pallas/mlp_kernel.py `_fwd_kernel` (body
`_fwd_body`, driven by `_run_fwd`); K5 replaces `_bwd_kernel` (driven by
`_fused_bwd`, the custom VJP). Both are CUDA C++ in `csrc/nerf_mlp.cu`;
its header says what bounds them on the card and how the design answers.

`nerf_mlp_fused` is the drop-in for encode + `apply_nerf` on models with
the viewdir head: [P, 3] points and [P, 3] directions → [P, 4] raw rgbσ.
It packs the input rows as [xyz, 0, dir, 0] and the parameters into one
flat weight vector and one flat bias vector (`pack_params`), in
differentiable torch ops, so autograd maps the kernel's padded dW/db back
onto the parameter dict. Padding as `_prep` does: the encoding to 64 and
32 channels (skip rows re-padded 63 → 64, view rows 27 → 32), alpha into
column 3 and rgb into columns 0:3 of 16-wide head matrices.

`_FusedMLP` is the autograd.Function: forward `mlp_forward` (K4, a
persistent wgmma kernel that streams the weights, packed by
`pack_stream` in the order of `k4_weight_stream`, through shared memory),
backward `mlp_backward` (K5: K5a, the per-tile recompute and backward,
writes each layer's bf16 input and output gradient to a per-point stash,
then K5b, a tensor-core GEMM, forms every dW from it; `K5Launch` holds the
buffers; its weights are packed by `pack_fragments`). Input gradients
are computed only when the packed input requires one
(`ctx.needs_input_grad`); otherwise the gradient is
None. On CUDA tensors the wrappers launch the kernels (counted in
`mlp_forward.launches` / `mlp_backward.launches`) or raise; on CPU tensors
they run `mlp_forward_plain` / `mlp_backward_plain`, the same arithmetic in
torch ops: operands rounded to `MATMUL_DTYPE` (bf16, as the kernels and
the TPU do; the CPU tests may set float32) and f32 products and sums.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nerfail_tpu_torch.config import NeRFModelConfig
from nerfail_tpu_torch.ops.cuda import build

TILE = 64            # rows of a K5 tile; n is a multiple of it (csrc/nerf_mlp.cu T)
K4_TILE = 128        # points per K4 tile, 64 per consumer warpgroup (K4_T)
SLICE = 64           # K rows of one stage of K4's weight stream
HEAD = 16            # head matrix columns: rgb 0:3, alpha 3
MAX_DEPTH = 16
MATMUL_DTYPE = torch.bfloat16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass(frozen=True)
class MlpDims:
    """The kernels' view of one architecture (the `dims` array of
    csrc/nerf_mlp.cu)."""

    depth: int
    width: int
    skips: Tuple[int, ...]
    multires: int
    multires_views: int
    in_pad: int
    vd_pad: int

    @staticmethod
    def _skips(cfg: NeRFModelConfig) -> Tuple[int, ...]:
        # a skip index ≥ D never fires (apply_nerf's `i in skips`)
        return tuple(sorted(s for s in set(cfg.skips)
                            if 0 <= s < cfg.netdepth))

    @staticmethod
    def rejects(cfg: NeRFModelConfig) -> Optional[str]:
        """Why the fused MLP cannot take this architecture, or None."""
        D, W = cfg.netdepth, cfg.netwidth
        if not cfg.use_viewdirs or cfg.i_embed != 0:
            return ("the fused MLP needs the viewdir head and the Fourier "
                    "encoding; use the unfused path")
        if not 1 <= D <= MAX_DEPTH or W % 32 or not 32 <= W <= 256:
            return (f"fused MLP takes depth 1..{MAX_DEPTH} and width a "
                    f"multiple of 32 in 32..256, got {D}×{W}")
        if D - 1 in MlpDims._skips(cfg):
            return ("a skip after the last layer widens the trunk past the "
                    "feature layer's input")
        return None

    @staticmethod
    def from_cfg(cfg: NeRFModelConfig) -> "MlpDims":
        reason = MlpDims.rejects(cfg)
        if reason is not None:
            raise ValueError(reason)
        D, W, skips = cfg.netdepth, cfg.netwidth, MlpDims._skips(cfg)
        return MlpDims(D, W, skips, cfg.multires, cfg.multires_views,
                       _round_up(cfg.input_ch, 64),
                       _round_up(cfg.input_ch_views, 32))

    def k_in(self, i: int) -> int:
        if i == 0:
            return self.in_pad
        return self.in_pad + self.width if (i - 1) in self.skips else self.width

    def w_shapes(self) -> List[Tuple[int, int]]:
        W = self.width
        return ([(self.k_in(i), W) for i in range(self.depth)]
                + [(W, W), (W + self.vd_pad, W // 2), (W, HEAD),
                   (W // 2, HEAD)])

    def b_sizes(self) -> List[int]:
        return [self.width] * (self.depth + 1) + [self.width // 2]

    def array(self):
        mask = sum(1 << s for s in self.skips)
        return (ctypes.c_int * 7)(self.depth, self.width, mask, self.multires,
                                  self.multires_views, self.in_pad,
                                  self.vd_pad)

    def macs_per_point(self) -> int:
        """Multiply-adds of one point's forward at `_prep`'s padded shapes
        (heads 8 wide, as on the TPU), the work the bounds count."""
        shapes = self.w_shapes()
        return sum(k * n for k, n in shapes[:-2]) + (self.width
                                                     + self.width // 2) * 8


def pack_params(params: Dict[str, torch.Tensor],
                dims: MlpDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat f32 weights, flat f32 biases) in the kernels' layout, built by
    differentiable ops from the parameter dict."""
    D, W = dims.depth, dims.width
    in_ch = 3 * (1 + 2 * dims.multires)
    ws = []
    for i in range(D):
        w = params[f"pts_{i}_w"]
        if i == 0:
            w = F.pad(w, (0, 0, 0, dims.in_pad - w.shape[0]))
        elif (i - 1) in dims.skips:      # rows [x(63) | h(W)] → re-pad x
            w = torch.cat([F.pad(w[:in_ch], (0, 0, 0, dims.in_pad - in_ch)),
                           w[in_ch:]], dim=0)
        ws.append(w)
    ws.append(params["feature_w"])
    vw = params["views_w"]
    ws.append(torch.cat([vw[:W], F.pad(vw[W:], (0, 0, 0, dims.vd_pad
                                                 - (vw.shape[0] - W)))], 0))
    ws.append(F.pad(params["alpha_w"], (3, HEAD - 4)))
    ws.append(F.pad(params["rgb_w"], (0, HEAD - 3)))
    for w, shape in zip(ws, dims.w_shapes()):
        if tuple(w.shape) != shape:
            raise ValueError(f"weight shape {tuple(w.shape)} != {shape}")
    bs = [params[f"pts_{i}_b"] for i in range(D)] + [params["feature_b"],
                                                     params["views_b"]]
    return (torch.cat([w.reshape(-1) for w in ws]),
            torch.cat([b.reshape(-1) for b in bs]))


def _split(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    out, o = [], 0
    for s in shapes:
        n = int(np.prod(s))
        out.append(flat[o:o + n].view(*s))
        o += n
    return out


@lru_cache(maxsize=None)
def _enc_consts(num_freqs: int, row0: int, out_pad: int):
    """(Sf [8, out_pad], masks [3, out_pad]) of one encoder, as the TPU
    kernel's `_enc_consts`: column c of xin @ Sf is the exact phase of
    channel c, mask rows select identity / sin / cos."""
    C = 3 * (1 + 2 * num_freqs)
    sf = np.zeros((8, out_pad), np.float32)
    m = np.zeros((3, out_pad), np.float32)
    for c in range(C):
        if c < 3:
            sf[row0 + c, c] = 1.0
            m[0, c] = 1.0
        else:
            k, r = divmod(c - 3, 6)
            sf[row0 + r % 3, c] = float(2.0 ** k)
            m[1 if r < 3 else 2, c] = 1.0
    return sf, m


@lru_cache(maxsize=None)
def _enc_consts_on(num_freqs: int, row0: int, out_pad: int, device: str):
    """`_enc_consts` on `device`, copied there once."""
    return tuple(torch.from_numpy(a).to(device)
                 for a in _enc_consts(num_freqs, row0, out_pad))


def _encode(xin: torch.Tensor, num_freqs: int, row0: int, out_pad: int):
    """(encoding [n, out_pad], phase, masks, Sf) of the packed rows."""
    sf, m = _enc_consts_on(num_freqs, row0, out_pad, str(xin.device))
    phase = xin @ sf          # one nonzero power of two per column: exact
    enc = m[0] * phase + m[1] * torch.sin(phase) + m[2] * torch.cos(phase)
    return enc, phase, m, sf


def _r(x: torch.Tensor) -> torch.Tensor:
    """An operand rounded as the kernels round it (round to nearest even)."""
    if MATMUL_DTYPE == torch.float32:
        return x
    return x.to(MATMUL_DTYPE).to(torch.float32)


def _forward_acts(xin, flat_w, flat_b, dims: MlpDims):
    D, W = dims.depth, dims.width
    ws = [_r(w) for w in _split(flat_w, dims.w_shapes())]
    bs = _split(flat_b, [(n,) for n in dims.b_sizes()])
    x, phase_x, mx, sfx = _encode(xin, dims.multires, 0, dims.in_pad)
    ed, phase_d, md, sfd = _encode(xin, dims.multires_views, 4, dims.vd_pad)
    x, ed = _r(x), _r(ed)
    h, ins, outs, z0 = x, [], [], None
    for i in range(D):
        ins.append(h)
        z = h @ ws[i] + bs[i]
        if i == 0:
            z0 = z
        a = _r(torch.relu(z))
        outs.append(a)
        h = torch.cat([x, a], -1) if i in dims.skips else a
    trunk = h
    hv_in = torch.cat([_r(trunk @ ws[D] + bs[D]), ed], -1)
    hv = _r(torch.relu(hv_in @ ws[D + 1] + bs[D + 1]))
    out = (trunk @ ws[D + 2] + hv @ ws[D + 3])[:, :4]
    return {"ws": ws, "ins": ins, "outs": outs, "trunk": trunk,
            "hv_in": hv_in, "hv": hv, "out": out, "z0": z0,
            "enc_x": (phase_x, mx, sfx), "enc_d": (phase_d, md, sfd)}


def mlp_forward_plain(xin: torch.Tensor, flat_w: torch.Tensor,
                      flat_b: torch.Tensor, dims: MlpDims) -> torch.Tensor:
    """The plain version of K4: [n, 8] packed rows → [n, 4] (no head
    biases)."""
    return _forward_acts(xin, flat_w, flat_b, dims)["out"]


def mlp_layer0_plain(xin, flat_w, flat_b, dims: MlpDims) -> torch.Tensor:
    """Layer 0's f32 pre-activation [n, W] (K4's `z0` probe)."""
    return _forward_acts(xin, flat_w, flat_b, dims)["z0"]


def mlp_backward_plain(xin, flat_w, flat_b, g, dims: MlpDims,
                       input_grads: bool):
    """The plain version of K5: recompute, then backpropagate g [n, 4]
    through heads, view layer, feature layer and trunk. Returns (d_xin
    [n, 8] or None, dW flat, db flat). f32 gradients, operands of every
    product rounded as in the forward; biases take f32 column sums."""
    D, W = dims.depth, dims.width
    a = _forward_acts(xin, flat_w, flat_b, dims)
    ws = a["ws"]
    gh = _r(F.pad(g, (0, HEAD - 4)))
    dW: List[Optional[torch.Tensor]] = [None] * (D + 4)
    dB: List[Optional[torch.Tensor]] = [None] * (D + 2)
    dW[D + 3] = a["hv"].T @ gh
    dW[D + 2] = a["trunk"].T @ gh
    d_hv = torch.where(a["hv"] > 0, gh @ ws[D + 3].T, 0.0)
    dB[D + 1] = d_hv.sum(0)
    d_hv = _r(d_hv)
    dW[D + 1] = a["hv_in"].T @ d_hv
    d_hv_in = d_hv @ ws[D + 1].T
    d_feat, d_enc_d = d_hv_in[:, :W], d_hv_in[:, W:]
    dB[D] = d_feat.sum(0)
    d_feat = _r(d_feat)
    dW[D] = a["trunk"].T @ d_feat
    d_h = d_feat @ ws[D].T + gh @ ws[D + 2].T
    d_x = torch.zeros(xin.shape[0], dims.in_pad, device=xin.device)
    for i in reversed(range(D)):
        if i in dims.skips:
            d_x = d_x + d_h[:, :dims.in_pad]
            d_h = d_h[:, dims.in_pad:]
        d_z = torch.where(a["outs"][i] > 0, d_h, 0.0)
        dB[i] = d_z.sum(0)
        d_z = _r(d_z)
        dW[i] = a["ins"][i].T @ d_z
        if i > 0 or input_grads:
            d_h = d_z @ ws[i].T
    d_xin = None
    if input_grads:
        d_x = d_x + d_h
        (px, mx, sfx), (pd, md, sfd) = a["enc_x"], a["enc_d"]
        jx = mx[0] + mx[1] * torch.cos(px) - mx[2] * torch.sin(px)
        jd = md[0] + md[1] * torch.cos(pd) - md[2] * torch.sin(pd)
        d_xin = (jx * d_x) @ sfx.T + (jd * d_enc_d) @ sfd.T
    return (d_xin, torch.cat([w.reshape(-1) for w in dW]),
            torch.cat([b.reshape(-1) for b in dB]))


# ------------------------------------------------------------- the kernels


@lru_cache(maxsize=None)
def fragment_order(dims: MlpDims) -> np.ndarray:
    """Where each element of the kernels' packed weights comes from in the
    flat weights: first every W_j as the forward's [K, N] operand, then
    every W_jᵀ as the backward's, each cut into 16×16 fragments
    ([K/16][N/16]) of 32 lanes × 8 values in the register order of
    mma.sync.m16n8k16's B operand: lane (g, t) = (l // 4, l % 4) holds rows
    2t + (0, 1, 8, 9) of column g, then of column 8 + g. Each packed half
    has the flat weights' size and offsets."""
    lane = np.arange(32)[:, None]
    j = np.arange(8)[None, :]
    g, t = lane // 4, lane % 4
    kk = 2 * t + j % 2 + 8 * (j % 4 // 2)              # [32, 8]
    nn = 8 * (j // 4) + g
    fwd, bwd, o = [], [], 0
    for k, n in dims.w_shapes():
        src = o + np.arange(k * n).reshape(k, n)
        for mat, out in ((src, fwd), (src.T, bwd)):
            kt = np.arange(mat.shape[0] // 16)[:, None, None, None]
            nt = np.arange(mat.shape[1] // 16)[None, :, None, None]
            out.append(mat[16 * kt + kk, 16 * nt + nn].reshape(-1))
        o += k * n
    return np.concatenate(fwd + bwd)


@lru_cache(maxsize=None)
def _fragment_index(dims: MlpDims, device: str) -> torch.Tensor:
    return torch.from_numpy(fragment_order(dims)).to(device)


def pack_fragments(flat_w: torch.Tensor, dims: MlpDims) -> torch.Tensor:
    """The kernels' weights: flat_w in bf16, in `fragment_order`."""
    idx = _fragment_index(dims, str(flat_w.device))
    return flat_w.to(torch.bfloat16)[idx]


def _stream_parts(dims: MlpDims) -> List[Tuple[int, str, int, int]]:
    """K4's operands in the order the kernel consumes them: (flat matrix
    index j, operand, k_lo, k_hi), the operand covering rows [k_lo, k_hi)
    of W_j; j follows `MlpDims.w_shapes` (W_0..W_{D-1}, feature D, views
    D+1, alpha D+2, rgb D+3)."""
    D, W, xp = dims.depth, dims.width, dims.in_pad
    parts = []
    for i in range(D):
        x_in = i == 0 or (i - 1) in dims.skips
        if x_in:
            parts.append((i, "enc_x", 0, xp))
        if i > 0:
            off = xp if x_in else 0
            parts.append((i, "h", off, off + W))
    parts += [(D + 2, "trunk", 0, W), (D, "trunk", 0, W),
              (D + 1, "feature", 0, W), (D + 1, "enc_d", W, W + dims.vd_pad),
              (D + 3, "hv", 0, W // 2)]
    return parts


def k4_weight_stream(dims: MlpDims
                     ) -> List[Tuple[int, str, int, int, int, int]]:
    """K4's stream, one entry per ring stage, in the order the kernel's
    producer copies them and its consumers multiply by them: (matrix j,
    operand, first row k0 of W_j, rows ≤ SLICE, columns n, byte offset).
    Trunk layers W_0..W_{D-1}, then alpha (on the trunk, before the
    feature layer overwrites it), feature, views (on [feature | enc_d]),
    rgb (on hv). A stage is Wᵀ[:, k0:k0 + rows] as [n, SLICE] bf16, K-major
    in wgmma's 128-byte swizzle, zero past `rows`: n · 128 bytes."""
    shapes = dims.w_shapes()
    out, off = [], 0
    for j, operand, lo, hi in _stream_parts(dims):
        n = shapes[j][1]
        for k0 in range(lo, hi, SLICE):
            out.append((j, operand, k0, min(SLICE, hi - k0), n, off))
            off += n * SLICE * 2
    return out


@lru_cache(maxsize=None)
def k4_stream_index(dims: MlpDims) -> np.ndarray:
    """Where each bf16 of K4's stream comes from in the flat weights, or
    the flat weights' size (a zero) for the padding. Element (c, k) of a
    stage (column c of W_j, row k0 + k) sits at c · 64 + ((k // 8) ^ (c %
    8)) · 8 + k % 8: 16-byte chunk k // 8 of the stage's 128-byte row c
    moves to chunk (k // 8) ^ (c % 8)."""
    shapes = dims.w_shapes()
    w_off = np.cumsum([0] + [k * n for k, n in shapes])
    pieces = []
    for j, _, k0, rows, n, _ in k4_weight_stream(dims):
        c = np.arange(n)[:, None]
        k = np.arange(SLICE)[None, :]
        src = np.where(k < rows, w_off[j] + (k0 + np.minimum(k, rows - 1)) * n
                       + c, w_off[-1])
        img = np.empty(n * SLICE, np.int64)
        img[(c * SLICE + ((k // 8) ^ (c % 8)) * 8 + k % 8).reshape(-1)] = (
            src.reshape(-1))
        pieces.append(img)
    return np.concatenate(pieces)


@lru_cache(maxsize=None)
def _stream_index(dims: MlpDims, device: str) -> torch.Tensor:
    return torch.from_numpy(k4_stream_index(dims)).to(device)


def pack_stream(flat_w: torch.Tensor, dims: MlpDims) -> torch.Tensor:
    """K4's weights: flat_w in bf16 in `k4_stream_index` order, packed
    anew on every call (training changes the weights every step)."""
    idx = _stream_index(dims, str(flat_w.device))
    w = torch.cat([flat_w.to(torch.bfloat16),
                   flat_w.new_zeros(1, dtype=torch.bfloat16)])
    return w[idx]


def k4_schedule(n: int, sms: int) -> List[Tuple[int, int, int, int]]:
    """K4's persistent schedule, as csrc/nerf_mlp.cu runs it: min(sms,
    tiles) blocks, block b takes tiles b, b + G, ... of K4_TILE points and
    its consumer warpgroup c rows 64c.. of each. Returns (block, tile,
    consumer, first row) for every half that holds rows (the last tile
    may hold only 64)."""
    tiles = -(-n // K4_TILE)
    grid = min(sms, tiles)
    return [(blk, t, c, t * K4_TILE + 64 * c)
            for blk in range(grid) for t in range(blk, tiles, grid)
            for c in range(2) if t * K4_TILE + 64 * c < n]


K4_BLOCK = 64 * 128          # bytes of a [64, 64] bf16 swizzled block
K4_MAX_STAGES = 8
K4_SMEM_LIMIT = 232448       # a block's shared memory on an H100


def k4_stages(dims: MlpDims) -> int:
    """K4's ring stages as `make_k4` plans them (`kernel_sizes(dims)[6]`
    on the card): as many stages of 128·W bytes as fit beside both
    consumers' encoding and activation tiles and the barriers, at most
    K4_MAX_STAGES."""
    blocks = sum(-(-k // SLICE) for k in (dims.in_pad, dims.vd_pad,
                                           dims.width))
    fixed = 1024 + 2 * K4_BLOCK * blocks + 16 * K4_MAX_STAGES
    slot = 128 * dims.width
    if fixed + 2 * slot > K4_SMEM_LIMIT:
        raise ValueError("K4's tiles leave no room for two ring stages")
    return min((K4_SMEM_LIMIT - fixed) // slot, K4_MAX_STAGES)


def k4_runs(dims: MlpDims, tiles: int) -> List[int]:
    """The slices one K4 consumer issues between two of its epilogues, in
    stream order over `tiles` tiles: each trunk layer, alpha + feature,
    views, rgb. Each run ends with every product retired (`drain`)."""
    per: Dict[int, int] = {}
    for j, *_ in k4_weight_stream(dims):
        per[j] = per.get(j, 0) + 1
    D = dims.depth
    return tiles * (
        [per[i] for i in range(D)] + [per[D + 2] + per[D], per[D + 1],
                                      per[D + 3]])


def k4_order(runs: List[int], stages: int, turns: Optional[List[int]] = None,
             pick=None) -> List[tuple]:
    """The ring protocol of one K4 block, walked. A producer fills slices
    0, 1, ... in order into stages j % `stages`, each once both consumers
    released the slice before it there (the stage's empty barrier: 2
    arrivals a phase here, 8 on the card). Each consumer, for each slice,
    waits for its fill, issues it, and releases the slice before (wait_group
    1); at the end of a run it retires everything and releases the run's
    last slice too. With `turns` (slice counts that cut every run), the
    consumers also take turns: each waits for its turn before a turn's
    first slice and passes it on after the turn's last, consumer 0 first.
    `pick(enabled)` chooses which enabled actor (0, 1: consumers, 2:
    producer) moves; None takes the first. Returns the events ("fill",
    stage, slice), ("issue", consumer, slice), ("release", consumer,
    slice) and ("pass", consumer, turn); raises RuntimeError when no
    actor can move before the end."""
    total = sum(runs)
    drains = set((np.cumsum(runs) - 1).tolist())
    starts = set() if turns is None else set(
        (np.cumsum(turns) - np.array(turns)).tolist())
    arrivals = [0] * stages            # empty barrier arrivals per stage
    fills = [0] * stages               # fills per stage so far
    passes = [1, 0]                    # turns each consumer may start:
    # consumer 1 passes once before the first turn
    filled = 0
    cons = [dict(turn=0, j=0, pend=None) for _ in range(2)]
    events = []

    def enabled(a):
        if a == 2:
            return filled < total and arrivals[filled % stages] >= 2 * (
                filled // stages)
        c = cons[a]
        if c["j"] == total:
            return False
        if c["j"] in starts and passes[a] <= c["turn"]:
            return False
        j = c["j"]                     # its fill: the stage's (j // S)-th
        return fills[j % stages] > j // stages

    def release(a, j):
        arrivals[j % stages] += 1
        events.append(("release", a, j))

    while filled < total or any(c["j"] < total for c in cons):
        ready = [a for a in (0, 1, 2) if enabled(a)]
        if not ready:
            raise RuntimeError(f"K4's ring protocol stalls: {len(events)} "
                               f"events, fills {filled} of {total}, "
                               f"consumers at {[c['j'] for c in cons]}")
        a = ready[0] if pick is None else pick(ready)
        if a == 2:
            fills[filled % stages] += 1
            events.append(("fill", filled % stages, filled))
            filled += 1
            continue
        c = cons[a]
        j = c["j"]
        if fills[j % stages] != j // stages + 1:
            raise RuntimeError(f"slice {j} was overwritten before "
                               f"consumer {a} issued it")
        events.append(("issue", a, j))
        c["j"] += 1
        if turns is not None and c["j"] in starts | {total}:
            passes[1 - a] += 1
            events.append(("pass", a, c["turn"]))
            c["turn"] += 1
        if c["pend"] is not None:
            release(a, c["pend"])
        c["pend"] = j
        if j in drains:
            release(a, j)
            c["pend"] = None
    return events


def _lib():
    lib = build.load("nerf_mlp")
    lib.nerf_mlp_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nerf_mlp_sizes.restype = ctypes.c_int
    lib.nerf_mlp_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.nerf_mlp_fwd_launch.restype = ctypes.c_int
    lib.nerf_mlp_bwd_pass_launch.argtypes = [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nerf_mlp_bwd_pass_launch.restype = ctypes.c_int
    lib.nerf_mlp_wgrad_launch.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    lib.nerf_mlp_wgrad_launch.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def kernel_sizes(dims: MlpDims) -> Tuple[int, ...]:
    """(weights, biases, bf16 stash elements per point, K4 and K5a shared
    bytes, K4's weight stream bytes, K4's ring stages) as csrc/nerf_mlp.cu
    computes them."""
    out = (ctypes.c_longlong * 7)()
    build.check(_lib().nerf_mlp_sizes(dims.array(), out), "nerf_mlp_sizes")
    return tuple(int(v) for v in out)


def _check(xin, flat_w, flat_b, dims: MlpDims, what: str) -> bool:
    """True for CPU tensors (the plain version runs); else checks that the
    kernel can take them and raises if not."""
    if xin.ndim != 2 or xin.shape[1] != 8:
        raise ValueError(f"{what}: xin must be [n, 8], got {tuple(xin.shape)}")
    if xin.device.type == "cpu":
        return True
    if xin.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {xin.device}")
    n_w = sum(k * n for k, n in dims.w_shapes())
    n_b = sum(dims.b_sizes())
    for name, t, numel in (("xin", xin, None), ("flat_w", flat_w, n_w),
                           ("flat_b", flat_b, n_b)):
        if (t.device != xin.device or t.dtype != torch.float32
                or not t.is_contiguous()
                or (numel is not None and t.numel() != numel)):
            raise ValueError(f"{what}: {name} must be contiguous float32 on "
                             f"{xin.device} with the packed layout")
    if xin.shape[0] % TILE:
        raise ValueError(f"{what}: rows must be a multiple of {TILE}")
    sizes = kernel_sizes(dims)
    if sizes[:3] != (n_w, n_b, sum(sum(p) for p in stash_planes(dims))) or (
            sizes[5] != 2 * len(k4_stream_index(dims))):
        raise ValueError(f"{what}: layout disagrees with csrc/nerf_mlp.cu")
    return False


def mlp_forward(xin: torch.Tensor, flat_w: torch.Tensor, flat_b: torch.Tensor,
                dims: MlpDims, z0: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """K4: [n, 8] packed rows → [n, 4] raw rgbσ without the head biases.
    CUDA tensors launch the kernel (one persistent block per SM, the
    weights packed by `pack_stream`); `z0` ([n, W] f32), when given,
    receives layer 0's pre-activation. CPU tensors take the plain
    version."""
    if _check(xin, flat_w, flat_b, dims, "mlp_forward"):
        return mlp_forward_plain(xin, flat_w, flat_b, dims)
    n = xin.shape[0]
    out = torch.empty(n, 4, dtype=torch.float32, device=xin.device)
    if z0 is not None and (z0.shape != (n, dims.width) or not z0.is_cuda
                           or z0.dtype != torch.float32
                           or not z0.is_contiguous()):
        raise ValueError("mlp_forward: z0 must be contiguous f32 [n, W]")
    wp = pack_stream(flat_w, dims)
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().nerf_mlp_fwd_launch(
            dims.array(), xin.data_ptr(), wp.data_ptr(), flat_b.data_ptr(),
            out.data_ptr(), None if z0 is None else z0.data_ptr(), n, stream)
    build.check(status, "nerf_mlp_fwd_launch")
    mlp_forward.launches += 1
    return out


mlp_forward.launches = 0


def stash_planes(dims: MlpDims) -> Tuple[List[int], List[int]]:
    """Widths of K5's per-point stash planes, each [n, width] bf16: the A
    planes (inputs of W_0..W_{D-1}, the trunk, [feature | enc_d], hv) and
    the dZ planes (W_0..W_{D-1}, feature, views, the 16-wide heads)."""
    D, W = dims.depth, dims.width
    return ([dims.k_in(i) for i in range(D)] + [W, W + dims.vd_pad, W // 2],
            [W] * (D + 1) + [W // 2, HEAD])


WGRAD_ROWS = 128     # rows of dW per K5b block (csrc/nerf_mlp.cu BM)


def wgrad_tiles(dims: MlpDims) -> List[Tuple[int, int, int]]:
    """K5b's output tiles, (matrix j, first row, rows): every dW_j cut into
    row tiles of at most WGRAD_ROWS rows (all its columns), in the flat
    order, so each dW entry lies in exactly one tile."""
    return [(j, m0, min(WGRAD_ROWS, k - m0))
            for j, (k, _) in enumerate(dims.w_shapes())
            for m0 in range(0, k, WGRAD_ROWS)]


WGRAD_WAVES = 8


def wgrad_chunk(n: int, n_tiles: int, sms: int) -> int:
    """Points per split of K5b, a multiple of TILE: about WGRAD_WAVES
    blocks per SM over all splits, so the last wave is a short tail. The
    splits, and so the order of the dW sums, depend only on n, the
    architecture and the card."""
    splits = max(1, min(n // TILE, -(-WGRAD_WAVES * sms // n_tiles)))
    return _round_up(-(-n // splits), TILE)


@lru_cache(maxsize=None)
def _tile_table(dims: MlpDims, device: str) -> torch.Tensor:
    return torch.tensor(wgrad_tiles(dims), dtype=torch.int32, device=device)


def backward_blocks(device: torch.device, n: int) -> int:
    """K5a's grid: two blocks per SM, as many as its shared memory lets run
    at once at 8×256 (fixed for a card, so the order of the db sums, and
    the result, is too), fewer for a short input."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n // TILE, 2 * sms))


@dataclass
class K5Launch:
    """K5's buffers for one call and its two kernels: `pass_` (K5a: the
    recompute, the backward through every layer, the stash and db) and
    `wgrad` (K5b: dW from the stash). `mlp_backward` runs both."""

    dims: MlpDims
    xin: torch.Tensor
    wp: torch.Tensor
    flat_b: torch.Tensor
    g: torch.Tensor
    d_xin: Optional[torch.Tensor]
    stash: torch.Tensor
    db_part: torch.Tensor
    part: torch.Tensor
    dw: torch.Tensor
    db: torch.Tensor
    tiles: torch.Tensor
    chunk: int

    @staticmethod
    def prepare(xin, flat_w, flat_b, g, dims: MlpDims,
                input_grads: bool) -> "K5Launch":
        n = xin.shape[0]
        if (g.shape != (n, 4) or g.device != xin.device
                or g.dtype != torch.float32 or not g.is_contiguous()):
            raise ValueError("mlp_backward: g must be contiguous f32 [n, 4]")
        n_w, n_b, stash_cols = kernel_sizes(dims)[:3]
        dev = xin.device
        tiles = _tile_table(dims, str(dev))
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        chunk = wgrad_chunk(n, len(tiles), sms)
        f32 = dict(dtype=torch.float32, device=dev)
        return K5Launch(
            dims, xin, pack_fragments(flat_w, dims), flat_b, g,
            torch.empty(n, 8, **f32) if input_grads else None,
            torch.empty(n * stash_cols, dtype=torch.bfloat16, device=dev),
            torch.empty(backward_blocks(dev, n), n_b, **f32),
            torch.empty(-(-n // chunk), n_w, **f32),
            torch.empty(n_w, **f32), torch.empty(n_b, **f32), tiles, chunk)

    def pass_(self) -> None:
        self.db_part.zero_()
        with torch.cuda.device(self.xin.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().nerf_mlp_bwd_pass_launch(
                self.dims.array(), self.xin.data_ptr(), self.wp.data_ptr(),
                self.flat_b.data_ptr(), self.g.data_ptr(),
                None if self.d_xin is None else self.d_xin.data_ptr(),
                self.stash.data_ptr(), self.db_part.data_ptr(),
                self.db.data_ptr(), self.xin.shape[0], self.db_part.shape[0],
                stream)
        build.check(status, "nerf_mlp_bwd_pass_launch")

    def wgrad(self) -> None:
        with torch.cuda.device(self.xin.device):
            stream = torch.cuda.current_stream().cuda_stream
            status = _lib().nerf_mlp_wgrad_launch(
                self.dims.array(), self.stash.data_ptr(),
                self.tiles.data_ptr(), len(self.tiles), self.xin.shape[0],
                self.chunk, self.part.data_ptr(), self.dw.data_ptr(), stream)
        build.check(status, "nerf_mlp_wgrad_launch")


def mlp_backward(xin, flat_w, flat_b, g, dims: MlpDims, input_grads: bool):
    """K5: (d_xin [n, 8] or None, dW, db) for the cotangent g [n, 4] of
    `mlp_forward`. CUDA tensors launch its two kernels (K5a, then K5b;
    one count), CPU tensors take the plain version."""
    if _check(xin, flat_w, flat_b, dims, "mlp_backward"):
        return mlp_backward_plain(xin, flat_w, flat_b, g, dims, input_grads)
    k5 = K5Launch.prepare(xin, flat_w, flat_b, g, dims, input_grads)
    k5.pass_()
    k5.wgrad()
    mlp_backward.launches += 1
    return k5.d_xin, k5.dw, k5.db


mlp_backward.launches = 0


class _FusedMLP(torch.autograd.Function):
    """forward K4, backward K5 (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, xin, flat_w, flat_b, dims):
        ctx.save_for_backward(xin, flat_w, flat_b)
        ctx.dims = dims
        return mlp_forward(xin, flat_w, flat_b, dims)

    @staticmethod
    def backward(ctx, g):
        xin, flat_w, flat_b = ctx.saved_tensors
        d_xin, dw, db = mlp_backward(xin, flat_w, flat_b, g.contiguous(),
                                     ctx.dims, ctx.needs_input_grad[0])
        return d_xin, dw, db, None


def pack_input(pts: torch.Tensor, viewdirs: torch.Tensor) -> torch.Tensor:
    """[P, 8] rows [xyz, 0, dir, 0], zero rows appended up to a multiple
    of TILE (differentiable)."""
    P = pts.shape[0]
    z = torch.zeros(P, 1, dtype=pts.dtype, device=pts.device)
    xin = torch.cat([pts, z, viewdirs.to(pts.dtype), z], dim=-1)
    return F.pad(xin, (0, 0, 0, _round_up(P, TILE) - P))


def nerf_mlp_fused(params: Dict[str, torch.Tensor], cfg: NeRFModelConfig,
                   pts: torch.Tensor, viewdirs: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Drop-in for encode + apply_nerf: [P, 3] points and [P, 3] view
    directions → [P, 4] raw rgbσ, through K4/K5 on CUDA tensors."""
    if viewdirs is None:
        raise ValueError("the fused MLP needs view directions")
    dims = MlpDims.from_cfg(cfg)
    P = pts.shape[0]
    xin = pack_input(pts, viewdirs)
    flat_w, flat_b = pack_params(params, dims)
    out = _FusedMLP.apply(xin, flat_w, flat_b, dims)
    head_b = torch.cat([params["rgb_b"], params["alpha_b"]])
    return out[:P] + head_b
