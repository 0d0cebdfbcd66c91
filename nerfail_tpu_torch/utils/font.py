"""A 5×7 bitmap font for printable ASCII, drawn into numpy images.

The JAX package labels images with cv2.putText in Hershey triplex; the
card's machine has no cv2, PIL or imageio, so the port draws its labels
from this table. The glyphs are not Hershey's: text drawn here matches
cv2's in place, size and colour, not pixel for pixel.

Each glyph is 5 columns of 7 bits, bit 0 the top row, in a cell 6 dots
wide (one dot of spacing). A dot is `dot_size(scale)` pixels square, so at
scale 1 the glyphs stand 21 pixels tall, as cv2's triplex capitals do at
fontScale 1.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

_GLYPHS = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12"  # sp ! " # $
    "2313086462" "3649552250" "0005030000" "001c224100" "0041221c00"  # % & ' ( )
    "082a1c2a08" "08083e0808" "0050300000" "0808080808" "0060600000"  # * + , - .
    "2010080402" "3e5149453e" "00427f4000" "4261514946" "2141454b31"  # / 0 1 2 3
    "1814127f10" "2745454539" "3c4a494930" "0171090503" "3649494936"  # 4 5 6 7 8
    "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"  # 9 : ; < =
    "0041221408" "0201510906" "324979413e" "7e1111117e" "7f49494936"  # > ? @ A B
    "3e41414122" "7f4141221c" "7f49494941" "7f09090101" "3e41415132"  # C D E F G
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040"  # H I J K L
    "7f0204027f" "7f0408107f" "3e4141413e" "7f09090906" "3e4151215e"  # M N O P Q
    "7f09192946" "4649494931" "01017f0101" "3f4040403f" "1f2040201f"  # R S T U V
    "7f2018207f" "6314081463" "0304780403" "6151494543" "007f414100"  # W X Y Z [
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400"  # \ ] ^ _ `
    "2054545478" "7f48444438" "3844444420" "384444487f" "3854545418"  # a b c d e
    "087e090102" "0c5252523e" "7f08040478" "00447d4000" "2040443d00"  # f g h i j
    "007f102844" "00417f4000" "7c04180478" "7c08040478" "3844444438"  # k l m n o
    "7c14141408" "081414187c" "7c08040408" "4854545420" "043f444020"  # p q r s t
    "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"  # u v w x y
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0201020402"  # z { | } ~
)
CELL = 6          # dots a character advances
ROWS = 7


def dot_size(scale: float) -> int:
    """Pixels per dot at a cv2 fontScale of `scale`."""
    return max(1, int(round(3 * scale)))


def _glyph(ch: str) -> np.ndarray:
    """[7, 5] bool dots of one character ('?' for one outside 32..126)."""
    c = ord(ch)
    if not 32 <= c <= 126:
        c = ord("?")
    cols = np.frombuffer(_GLYPHS, np.uint8)[(c - 32) * 5:(c - 31) * 5]
    return ((cols[None, :] >> np.arange(ROWS)[:, None]) & 1).astype(bool)


def text_mask(text: str, scale: float) -> np.ndarray:
    """[7·d, 6·d·len(text)] bool pixels of `text`, d = dot_size(scale)."""
    d = dot_size(scale)
    dots = np.zeros((ROWS, CELL * len(text)), bool)
    for i, ch in enumerate(text):
        dots[:, CELL * i:CELL * i + 5] = _glyph(ch)
    return np.repeat(np.repeat(dots, d, axis=0), d, axis=1)


def put_text(img: np.ndarray, text: str, org: Tuple[int, int], scale: float,
             color: Sequence[int]) -> Tuple[int, int, int, int]:
    """Draw `text` into the [H, W, C] image in place, its bottom-left
    corner at org = (x, y) (cv2's origin: y is the baseline row), in
    `color`; pixels past the image's edge are dropped. Returns the text
    box (y0, y1, x0, x1), half-open and clipped to the image: no pixel
    outside it changes."""
    mask = text_mask(text, scale)
    x, y = org
    y0, x0 = y - mask.shape[0] + 1, x
    H, W = img.shape[:2]
    cy0, cy1 = max(y0, 0), min(y0 + mask.shape[0], H)
    cx0, cx1 = max(x0, 0), min(x0 + mask.shape[1], W)
    if cy0 >= cy1 or cx0 >= cx1:
        return cy0, cy0, cx0, cx0
    m = mask[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0]
    img[cy0:cy1, cx0:cx1][m] = np.asarray(color, img.dtype)[:img.shape[2]]
    return cy0, cy1, cx0, cx1
