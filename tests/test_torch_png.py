"""PyTorch port: the PNG codec (utils/png) against imageio and PIL.

Bit-exact throughout (tolerance 0): a decoder returns the stored bytes.
Files written by PIL (with its adaptive per-row filters) and by imageio
decode to what those libraries decode; files the codec writes read back
identically in both libraries; hand-built PNGs with each row filter 0-4
(and a mix of all five across rows) decode to the image they encode.
Palette, 16-bit, interlaced and JPEG input raise ValueError. Skips where
imageio is absent (the card's machine).
"""

import struct
import sys
import zlib

import numpy as np
import pytest

imageio = pytest.importorskip("imageio.v2")
from PIL import Image  # noqa: E402

from nerfail_tpu_torch.utils import png  # noqa: E402

MODES = [("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)]


def _image(rng, C, H=23, W=31, smooth=False):
    if smooth:       # gradients: PIL's adaptive filter picks Sub/Up/Paeth
        y, x = np.mgrid[:H, :W]
        img = (y[..., None] * 3 + x[..., None] * 5 + np.arange(C) * 40) % 256
        return img.astype(np.uint8)
    return rng.integers(0, 256, (H, W, C)).astype(np.uint8)


def _squeeze(img):
    return img[..., 0] if img.shape[-1] == 1 else img


@pytest.mark.parametrize("mode,C", MODES)
@pytest.mark.parametrize("smooth", [False, True])
def test_reads_what_pil_writes(tmp_path, mode, C, smooth):
    img = _squeeze(_image(np.random.default_rng(C), C, smooth=smooth))
    path = str(tmp_path / "pil.png")
    Image.fromarray(img, mode).save(path, optimize=True)
    got = png.imread(path)
    ref = np.asarray(imageio.imread(path))
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("mode,C", MODES)
def test_writes_what_imageio_and_pil_read(tmp_path, mode, C):
    img = _squeeze(_image(np.random.default_rng(10 + C), C))
    path = str(tmp_path / "own.png")
    png.imwrite(path, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    with Image.open(path) as im:
        assert im.mode == mode
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.imread(path), img)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _encode(img, types, color=None, depth=8, interlace=0):
    """A PNG whose row y is filtered by types[y] (PNG spec §9)."""
    H, W, C = img.shape
    x = img.astype(np.int32)
    up = np.concatenate([np.zeros((1, W, C), np.int32), x[:-1]])
    left = np.concatenate([np.zeros((H, 1, C), np.int32), x[:, :-1]], 1)
    ul = np.concatenate([np.zeros((H, 1, C), np.int32), up[:, :-1]], 1)
    preds = [0 * x, left, up, (left + up) // 2, _paeth(left, up, ul)]
    raw = b"".join(
        bytes([t]) + ((x[y] - preds[t][y]) % 256).astype(np.uint8).tobytes()
        for y, t in enumerate(types))
    color = {1: 0, 2: 4, 3: 2, 4: 6}[C] if color is None else color

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", W, H, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
@pytest.mark.parametrize("types", ["0", "1", "2", "3", "4", "mixed"])
def test_each_filter_type_bit_exact(tmp_path, C, types):
    rng = np.random.default_rng(ord(types[0]) * 7 + C)
    img = _image(rng, C, H=19, W=27)
    t = (rng.integers(0, 5, img.shape[0]) if types == "mixed"
         else np.full(img.shape[0], int(types)))
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, t))
    got = png.imread(str(path))
    np.testing.assert_array_equal(got, _squeeze(img))
    np.testing.assert_array_equal(got, np.asarray(imageio.imread(str(path))))


def test_wavefront_decodes_a_full_size_view(tmp_path):
    """800² RGBA, every row Paeth or Average: the anti-diagonal decode."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (800, 800, 4)).astype(np.uint8)
    path = tmp_path / "big.png"
    path.write_bytes(_encode(img, 3 + rng.integers(0, 2, 800)))
    np.testing.assert_array_equal(png.imread(str(path)), img)


@pytest.mark.parametrize("what,kw", [
    ("palette", dict(color=3)),
    ("16-bit", dict(depth=16)),
    ("interlaced", dict(interlace=1)),
])
def test_unsupported_png_raises(tmp_path, what, kw):
    img = np.zeros((4, 4, 1), np.uint8)
    path = tmp_path / "bad.png"
    path.write_bytes(_encode(img, np.zeros(4, int), **kw))
    with pytest.raises(ValueError, match=what) as e:
        png.imread(str(path))
    assert "bad.png" in str(e.value)


def test_pil_palette_and_16_bit_files_raise(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3)).astype(
        np.uint8)
    Image.fromarray(img).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.imread(str(tmp_path / "p.png"))
    Image.fromarray(img[..., 0].astype(np.uint16) * 257).save(
        tmp_path / "i16.png")
    with pytest.raises(ValueError, match="16-bit"):
        png.imread(str(tmp_path / "i16.png"))


def test_jpeg_raises(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (8, 8, 3)).astype(
        np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(path, format="JPEG")
    with pytest.raises(ValueError, match="JPEG"):
        png.imread(path)


def test_render_path_writes_pngs_without_imageio(tmp_path, monkeypatch):
    """render_path(save_dir=...) needs no imageio: with the module hidden
    it still writes NNN.png that read back as its to8b renders; only the
    video writer asks for imageio."""
    import torch

    from nerfail_tpu_torch.config import (
        ExperimentConfig, NeRFModelConfig, RenderConfig,
    )
    from nerfail_tpu_torch.data.synthetic import make_box_scene
    from nerfail_tpu_torch.models.nerf import init_nerf_params
    from nerfail_tpu_torch.render_path import render_path, to8b

    for name in [m for m in sys.modules if m.split(".")[0] == "imageio"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    cfg = ExperimentConfig(
        model=NeRFModelConfig(netdepth=2, netwidth=32, multires=4,
                              multires_views=2),
        render=RenderConfig(N_samples=8, N_importance=8, chunk=4096))
    gen = torch.Generator().manual_seed(0)
    params = {"coarse": init_nerf_params(gen, cfg.model, "cpu"),
              "fine": init_nerf_params(gen, cfg.model, "cpu")}
    sc = make_box_scene(n_train=2, n_val=0, n_test=0, H=12, W=12)
    rgbs, _ = render_path(params, cfg, sc.poses, 12, 12, sc.K,
                          save_dir=str(tmp_path))
    for i in range(2):
        np.testing.assert_array_equal(
            png.imread(str(tmp_path / f"{i:03d}.png")), to8b(rgbs[i]))
    with pytest.raises(ImportError, match="imageio"):
        render_path(params, cfg, sc.poses[:1], 12, 12, sc.K,
                    video_path=str(tmp_path / "v.mp4"))


@pytest.mark.parametrize("C", [3, 4])
def test_invert_disturbance_file_matches_jax(tmp_path, C):
    """utils/disturbance (through utils/png) writes what the JAX package's
    imageio version writes: equal decoded bytes."""
    jax_dist = pytest.importorskip("nerfail_tpu.utils.disturbance")
    from nerfail_tpu_torch.utils.disturbance import (
        invert_disturbance, invert_disturbance_file,
    )

    img = np.random.default_rng(C).integers(0, 256, (9, 13, C)).astype(
        np.uint8)
    src = str(tmp_path / "mask.png")
    png.imwrite(src, img)
    invert_disturbance_file(src, str(tmp_path / "t.png"))
    jax_dist.invert_disturbance_file(src, str(tmp_path / "j.png"))
    got = png.imread(str(tmp_path / "t.png"))
    np.testing.assert_array_equal(got, png.imread(str(tmp_path / "j.png")))
    assert got.shape == (9, 13, 4)
    rgba = np.random.default_rng(7).uniform(0, 255, (9, 13, 4))
    np.testing.assert_array_equal(invert_disturbance(rgba),
                                  jax_dist.invert_disturbance(rgba))
