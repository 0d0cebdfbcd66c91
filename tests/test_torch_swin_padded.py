"""PyTorch port: Swin-B on torchvision's padded shifted windows, held to
the plain reference `benchmark/reference/swin_b.py` on the CPU.

Seeded random weights at a small width (embed 32, depths (2, 2, 2, 2),
heads (2, 4, 8, 16), window 7) with the relative-position bias tables at
std 0.5, so that the bias and the masks move the logits. Inputs: 299²,
NeRFail's (stages 74, 37, 19, 10 padded to 77, 42, 21, 14; merges over
37 and 19), 203² (50, 25, 13, 7: the last stage one unshifted window)
and 75² (18, 9, 5, 3: the last two stages smaller than the window, the
JAX rule).

Tolerance 1e-5 of the largest reference value, for the logits and for
the input gradient of the attack's cross-entropy: both sides run the
same float32 operations and read 0 here; the margin is for another
CPU's BLAS summing in other orders. Masking the padded cells out as keys
moves the logits at 299² by 0.30 of the largest, dropping the shift masks
by 0.34.
"""

import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import swin_b as ref
from nerfail_tpu_torch.models.classifiers.swin import SwinB
from nerfail_tpu_torch.utils import profiling as prof

SMALL = dict(embed_dim=32, depths=(2, 2, 2, 2), num_heads=(2, 4, 8, 16),
             window=7)
TOL = 1e-5
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "swin_divisible_224.json")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    prof.clear_record()
    yield
    prof.clear_record()
    torch.set_num_threads(prev)


def seeded_state(model, seed):
    """Every parameter from one numpy stream: linear layers at std
    1/sqrt(fan_in), the patch convolution at sqrt(2/fan_in), bias tables
    at 0.5, LayerNorm scales 1 + 0.1 z, other vectors 0.1 z."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in model.state_dict().items():
        z = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if k.endswith("rel_pos_bias"):
            z *= 0.5
        elif v.dim() in (2, 4):
            z *= np.sqrt((2.0 if v.dim() == 4 else 1.0)
                         / np.prod(v.shape[1:]))
        elif "LayerNorm" in k and k.endswith("weight"):
            z = 1.0 + 0.1 * z
        else:
            z *= 0.1
        out[k] = torch.from_numpy(z)
    return out


def images(n, size, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.uniform(0, 255, (n, size, size, 3)).astype(np.float32))


def pair(size, seed=5):
    port = SwinB(8, image_size=size, **SMALL)
    plain = ref.SwinB(8, image_size=size, **SMALL)
    state = seeded_state(port, seed)
    port.load_state_dict(state)
    plain.load_state_dict(state)
    return port.eval(), plain.eval()


def logits_and_grad(model, x, labels):
    x = x.clone().requires_grad_(True)
    logits = model(x)
    (g,) = torch.autograd.grad(F.cross_entropy(logits, labels), x)
    return logits.detach(), g


def gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("size", [299, 203, 75])
def test_logits_and_input_gradient_match_the_reference(size):
    port, plain = pair(size)
    x, labels = images(2, size, 6), torch.tensor([4, 1])
    lp, gp = logits_and_grad(port, x, labels)
    lr, gr = logits_and_grad(plain, x, labels)
    assert gap(lp, lr) <= TOL
    assert gap(gp, gr) <= TOL


def _masking_padded_keys(x, attn, shift_size):
    """The reference's block attention with the padded cells masked out
    as keys: what torchvision does not do."""
    B, H, W, C = x.shape
    ws = attn.ws
    real = F.pad(torch.ones(1, H, W, 1), (0, 0, 0, -W % ws, 0, -H % ws))
    Hp, Wp = real.shape[1], real.shape[2]
    x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    s = [0 if ws >= Hp else shift_size, 0 if ws >= Wp else shift_size]
    x = torch.roll(x, (-s[0], -s[1]), (1, 2))
    real = torch.roll(real, (-s[0], -s[1]), (1, 2))

    def part(t):
        t = t.view(t.shape[0], Hp // ws, ws, Wp // ws, ws, t.shape[-1])
        return t.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, t.shape[-1])

    keys = part(real)[..., 0]                                  # [nW, N]
    mask = (ref.shift_mask(Hp, Wp, ws, s, x.device) if sum(s)
            else torch.zeros(keys.shape[0], ws * ws, ws * ws))
    mask = mask + torch.where(keys[:, None, :] > 0, 0.0, -1e9)
    y = attn(part(x), mask)
    y = y.view(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    y = torch.roll(y.reshape(B, Hp, Wp, C), (s[0], s[1]), (1, 2))
    return y[:, :H, :W]


def test_padded_cells_are_attended_as_torchvision_attends_them(monkeypatch):
    port, plain = pair(299)
    x = images(2, 299, 7)
    with torch.no_grad():
        lp, lr = port(x), plain(x)
        monkeypatch.setattr(ref, "shifted_window_attention",
                            _masking_padded_keys)
        lm = plain(x)
    assert gap(lp, lr) <= TOL
    assert gap(lm, lr) > 100 * TOL
    assert gap(lp, lm) > 100 * TOL


def test_window_divisible_size_keeps_the_unpadded_output():
    """At 224² (56, 28, 14, 7) nothing pads: the logits are those the
    unpadded port gave before the padded path (the golden), the rows
    counted as padding are 0, and the reference agrees."""
    port, plain = pair(224)
    x = images(2, 224, 6)
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        lp = port(x)
    counters = prof.trace_record()["counters"]
    assert counters["swin.pad_rows"] == 0 and counters["swin.qkv_rows"] > 0
    with open(GOLDEN) as f:
        golden = torch.tensor(json.load(f)["logits"])
    assert gap(lp, golden) <= 1e-6
    with torch.no_grad():
        assert gap(lp, plain(x)) <= TOL


def test_shift_and_mask_over_the_padded_grid():
    """At 299² every stage pads, so every odd block shifts by 3, its mask
    covering the padded grid's windows."""
    from nerfail_tpu_torch.models.classifiers.swin import SwinBlock

    blocks = [m for m in SwinB(8, image_size=299).modules()
              if isinstance(m, SwinBlock)]
    assert [b.shift for b in blocks] == [0, 3] * 12
    windows = [11 * 11] * 2 + [6 * 6] * 2 + [3 * 3] * 18 + [2 * 2] * 2
    for b, nw in zip(blocks, windows):
        assert b.ws == 7
        if b.mask is not None:
            assert b.mask.shape == (nw, 49, 49)


def test_spans_and_counters_of_one_forward():
    port, _ = pair(299)
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        port(images(2, 299, 6))
    rec = prof.trace_record()
    names = [s["name"] for s in rec["spans"]]
    assert names.count("swin.attention") == 8
    assert names.count("swin.mlp") == 8
    assert names.count("swin.merge") == 3
    sides = [(74, 77)] * 2 + [(37, 42)] * 2 + [(19, 21)] * 2 + [(10, 14)] * 2
    assert rec["counters"]["swin.qkv_rows"] == 2 * sum(p * p for _, p in sides)
    assert rec["counters"]["swin.pad_rows"] == 2 * sum(
        p * p - s * s for s, p in sides)


def test_no_record_outside_a_session():
    port, _ = pair(75)
    with torch.no_grad():
        port(images(1, 75, 6))
    assert prof.trace_record() == {"spans": [], "counters": {}}
