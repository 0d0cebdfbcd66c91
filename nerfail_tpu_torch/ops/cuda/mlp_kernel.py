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

`_FusedMLP` is the autograd.Function: forward `mlp_forward` (K4), backward
`mlp_backward` (K5). Input gradients are computed only when the packed
input requires one (`ctx.needs_input_grad`); otherwise the gradient is
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

TILE = 64            # points per block (csrc/nerf_mlp.cu T)
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
    def from_cfg(cfg: NeRFModelConfig) -> "MlpDims":
        if not cfg.use_viewdirs or cfg.i_embed != 0:
            raise ValueError("the fused MLP needs the viewdir head and the "
                             "Fourier encoding; use the unfused path")
        D, W = cfg.netdepth, cfg.netwidth
        # a skip index ≥ D never fires (apply_nerf's `i in skips`)
        skips = tuple(sorted(s for s in set(cfg.skips) if 0 <= s < D))
        if not 1 <= D <= MAX_DEPTH or W % 32 or not 32 <= W <= 256:
            raise ValueError(f"fused MLP takes depth 1..{MAX_DEPTH} and width "
                             f"a multiple of 32 in 32..256, got {D}×{W}")
        if D - 1 in skips:
            raise ValueError("a skip after the last layer widens the trunk "
                             "past the feature layer's input")
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


def _encode(xin: torch.Tensor, num_freqs: int, row0: int, out_pad: int):
    """(encoding [n, out_pad], phase, masks, Sf) of the packed rows."""
    sf, m = (torch.from_numpy(a).to(xin.device)
             for a in _enc_consts(num_freqs, row0, out_pad))
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


def _lib():
    lib = build.load("nerf_mlp")
    lib.nerf_mlp_sizes.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.nerf_mlp_sizes.restype = ctypes.c_int
    lib.nerf_mlp_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    lib.nerf_mlp_fwd_launch.restype = ctypes.c_int
    lib.nerf_mlp_bwd_launch.argtypes = [ctypes.c_void_p] * 11 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.nerf_mlp_bwd_launch.restype = ctypes.c_int
    return lib


def kernel_sizes(dims: MlpDims) -> Tuple[int, int, int, int, int]:
    """(weights, biases, stash elements per K5 block, K4 and K5 shared
    bytes) as csrc/nerf_mlp.cu computes them."""
    out = (ctypes.c_longlong * 5)()
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
    if sizes[:2] != (n_w, n_b):
        raise ValueError(f"{what}: layout disagrees with csrc/nerf_mlp.cu")
    return False


def mlp_forward(xin: torch.Tensor, flat_w: torch.Tensor, flat_b: torch.Tensor,
                dims: MlpDims, z0: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """K4: [n, 8] packed rows → [n, 4] raw rgbσ without the head biases.
    CUDA tensors launch the kernel; `z0` ([n, W] f32), when given, receives
    layer 0's pre-activation. CPU tensors take the plain version."""
    if _check(xin, flat_w, flat_b, dims, "mlp_forward"):
        return mlp_forward_plain(xin, flat_w, flat_b, dims)
    n = xin.shape[0]
    out = torch.empty(n, 4, dtype=torch.float32, device=xin.device)
    if z0 is not None and (z0.shape != (n, dims.width) or not z0.is_cuda
                           or z0.dtype != torch.float32
                           or not z0.is_contiguous()):
        raise ValueError("mlp_forward: z0 must be contiguous f32 [n, W]")
    w16 = flat_w.to(torch.bfloat16)
    with torch.cuda.device(xin.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().nerf_mlp_fwd_launch(
            dims.array(), xin.data_ptr(), w16.data_ptr(), flat_b.data_ptr(),
            out.data_ptr(), None if z0 is None else z0.data_ptr(), n, stream)
    build.check(status, "nerf_mlp_fwd_launch")
    mlp_forward.launches += 1
    return out


mlp_forward.launches = 0


def backward_blocks(device: torch.device, n: int) -> int:
    """K5's grid: one block per SM (fixed for a card, so the order of the
    dW sums, and the result, is too), fewer for a short input."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n // TILE, sms))


def mlp_backward(xin, flat_w, flat_b, g, dims: MlpDims, input_grads: bool):
    """K5: (d_xin [n, 8] or None, dW, db) for the cotangent g [n, 4] of
    `mlp_forward`. CUDA tensors launch the kernel, CPU tensors take the
    plain version."""
    if _check(xin, flat_w, flat_b, dims, "mlp_backward"):
        return mlp_backward_plain(xin, flat_w, flat_b, g, dims, input_grads)
    n = xin.shape[0]
    if (g.shape != (n, 4) or g.device != xin.device
            or g.dtype != torch.float32 or not g.is_contiguous()):
        raise ValueError("mlp_backward: g must be contiguous f32 [n, 4]")
    n_w, n_b, stash_elems, _, _ = kernel_sizes(dims)
    blocks = backward_blocks(xin.device, n)
    dev = xin.device
    stash = torch.empty(blocks * stash_elems, dtype=torch.bfloat16, device=dev)
    dw_part = torch.zeros(blocks, n_w, dtype=torch.float32, device=dev)
    db_part = torch.zeros(blocks, n_b, dtype=torch.float32, device=dev)
    dw = torch.empty(n_w, dtype=torch.float32, device=dev)
    db = torch.empty(n_b, dtype=torch.float32, device=dev)
    d_xin = torch.empty(n, 8, dtype=torch.float32, device=dev) \
        if input_grads else None
    w16 = flat_w.to(torch.bfloat16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        status = _lib().nerf_mlp_bwd_launch(
            dims.array(), xin.data_ptr(), w16.data_ptr(), flat_b.data_ptr(),
            g.data_ptr(), None if d_xin is None else d_xin.data_ptr(),
            stash.data_ptr(), dw_part.data_ptr(), db_part.data_ptr(),
            dw.data_ptr(), db.data_ptr(), n, blocks, stream)
    build.check(status, "nerf_mlp_bwd_launch")
    mlp_backward.launches += 1
    return d_xin, dw, db


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
