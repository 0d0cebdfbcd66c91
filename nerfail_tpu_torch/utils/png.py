"""PNG reader and writer on the standard library and numpy.

The port's counterpart of the JAX package's `imageio` calls: every scene
loader, the attack's image dump and `render_path` read and write PNGs
through this module, so nothing on those paths needs imageio, PIL or cv2.

`imread` decodes 8-bit, non-interlaced gray, gray+alpha, RGB and RGBA
PNGs with all five row filters (PNG spec §9). Rows filtered None, Sub or
Up decode a row at a time (Sub is a per-channel cumulative sum mod 256).
Average and Paeth read the left neighbour and the row above, so when any
row uses them the image decodes by anti-diagonals: pixel (y, x) needs only
pixels of earlier diagonals, so each diagonal is one vectorised step over
the rows that cross it, each row predicting by its own filter type —
H + W − 1 steps in all. Anything else (a palette, 16-bit samples,
interlacing, a file that is not a PNG) raises ValueError; nothing falls
back to another library.

`imwrite` writes filter 0 (None) rows through zlib level 6.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}          # color type → samples a pixel
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes, path: str):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without an IEND chunk")


def imread(path: str) -> np.ndarray:
    """The image at `path` as uint8: [H, W] gray, [H, W, 2] gray+alpha,
    [H, W, 3] RGB or [H, W, 4] RGBA, as imageio.v2.imread returns it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        kind = "a JPEG" if data[:3] == b"\xff\xd8\xff" else "not a PNG"
        raise ValueError(f"{path}: {kind} file; only PNG is supported")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, color, compression, filt, interlace = header
    if color == 3:
        raise ValueError(f"{path}: palette PNGs are unsupported")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: PNG color type {color} is unsupported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNG samples are unsupported "
                         "(8-bit only)")
    if interlace != 0:
        raise ValueError(f"{path}: interlaced PNGs are unsupported")
    if compression != 0 or filt != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    C = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 1 + W * C
    if raw.size < H * stride:
        raise ValueError(f"{path}: PNG image data is truncated")
    rows = raw[:H * stride].reshape(H, stride)
    types = rows[:, 0]
    if int(types.max(initial=0)) > 4:
        raise ValueError(f"{path}: PNG row filter type > 4")
    filtered = rows[:, 1:].reshape(H, W, C)
    if np.any(types >= 3):
        img = _unfilter_wavefront(filtered, types)
    else:
        img = _unfilter_rows(filtered, types)
    return img[..., 0] if C == 1 else img


def _unfilter_rows(f: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Rows filtered None (0), Sub (1) or Up (2), one row at a time."""
    out = np.empty_like(f)
    prev = np.zeros_like(f[0])
    for y, t in enumerate(types):
        if t == 0:
            out[y] = f[y]
        elif t == 1:
            out[y] = np.cumsum(f[y], axis=0, dtype=np.uint8)
        else:
            out[y] = f[y] + prev
        prev = out[y]
    return out


def _unfilter_wavefront(f: np.ndarray, types: np.ndarray) -> np.ndarray:
    """Every filter type, one anti-diagonal (y + x = d) at a time.

    The reconstruction lives in a zero-padded [(H+1)·(W+1), C] table so
    that row −1 and column −1 read as 0, as the spec asks; each pixel
    reads its left (a), upper (b) and upper-left (c) neighbours there."""
    H, W, C = f.shape
    Wp = W + 1
    rec = np.zeros(((H + 1) * Wp, C), np.int16)
    fl = f.reshape(H * W, C).astype(np.int16)
    t_all = types.astype(np.int64)
    for d in range(H + W - 1):
        y = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - y
        at = (y + 1) * Wp + (x + 1)
        a = rec[at - 1]
        b = rec[at - Wp]
        c = rec[at - Wp - 1]
        t = t_all[y][:, None]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(t == 1, a,
               np.where(t == 2, b,
               np.where(t == 3, (a + b) >> 1,
               np.where(t == 4, paeth, 0))))
        rec[at] = (fl[y * W + x] + pred) & 255
    return rec.reshape(H + 1, Wp, C)[1:, 1:].astype(np.uint8)


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def imwrite(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C = 1, 2, 3, 4) image as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: imwrite takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"{path}: cannot write an image of shape "
                         f"{img.shape} as PNG")
    H, W, C = img.shape
    raw = np.zeros((H, 1 + W * C), np.uint8)
    raw[:, 1:] = img.reshape(H, W * C)
    header = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))
