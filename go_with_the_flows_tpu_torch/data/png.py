"""A PNG reader for the offline preprocessing of the SVR renderings
(cli/preprocess_shapenetall.py), on zlib, struct and numpy: the JAX
package's script reads them with cv2, which the card's machine lacks.

It reads what ShapeNetRendering holds and nothing else: 8-bit,
non-interlaced images of colour type 6 (RGBA) or 2 (RGB, whose alpha is
255), any of the five row filters, the image data in one or several IDAT
chunks. Anything else (another bit depth or colour type, interlacing, a
transparency chunk on an RGB image, an unknown critical chunk, a bad
CRC, truncated data) raises ValueError: it never guesses.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # colour type -> bytes a pixel at 8 bits


def _chunks(data: bytes):
    """(type, body) of each chunk after the signature, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4
    raise ValueError("PNG: no IEND chunk")


def _diagonals(filt: np.ndarray, ftype: np.ndarray,
               prior: np.ndarray) -> np.ndarray:
    """The (n, width, bpp) pixels of the n filtered rows `filt`, row i by
    filter type ftype[i], below the reconstructed row `prior`.

    Pixel (r, x) depends on its left, upper and upper-left neighbours
    only, so the pixels of one anti-diagonal r + x = d are independent
    of each other: each step reconstructs a whole diagonal, in exact
    integer arithmetic mod 256. The pixels lie diagonal-major, pixel
    (r, x) at S[r + x + 2, r + 1], so that a diagonal and its neighbours
    are slices; S[x + 1, 0] is prior's pixel x, and the cells no pixel
    takes are the zeros beyond the image's edges."""
    n, width, bpp = filt.shape
    r = np.arange(n)[:, None]
    x = np.arange(width)[None, :]
    S = np.zeros((n + width + 1, n + 1, bpp), np.int32)
    S[np.arange(width) + 1, 0] = prior
    F = np.zeros_like(S)
    F[r + x + 2, r + 1] = filt
    ftype = ftype[:, None]
    for d in range(n + width - 1):
        lo, hi = max(0, d - width + 1), min(n - 1, d)
        a = S[d + 1, lo + 1:hi + 2]  # left
        b = S[d + 1, lo:hi + 1]      # up
        c = S[d, lo:hi + 1]          # up-left
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[lo:hi + 1], [0, a, b, (a + b) >> 1, paeth])
        S[d + 2, lo + 1:hi + 2] = (F[d + 2, lo + 1:hi + 2] + pred) & 255
    return S[r + x + 2, r + 1].astype(np.uint8)


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """The (height, width, bpp) pixels of the filtered scanlines `raw`.

    A row filtered by None, Sub or Up is one vectorised step (Sub is a
    running sum mod 256 along the row); Average and Paeth chain each
    pixel to its left neighbour, so the rows from the first to the last
    that use them go through _diagonals."""
    stride = 1 + width * bpp
    if len(raw) != height * stride:
        raise ValueError(f"PNG: {len(raw)} bytes of image data, expected "
                         f"{height * stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG: unknown row filter {ftype.max()}")
    filt = rows[:, 1:].reshape(height, width, bpp)
    # out[0] is the row of zeros above the image; uint8 sums wrap mod 256
    out = np.zeros((height + 1, width, bpp), np.uint8)

    def by_row(rs):
        for r in rs:
            t = ftype[r]
            out[r + 1] = (filt[r] if t == 0 else
                          np.cumsum(filt[r], axis=0, dtype=np.uint8) if t == 1
                          else filt[r] + out[r])

    chained = np.flatnonzero(ftype >= 3)
    first, last = ((chained[0], chained[-1] + 1) if len(chained)
                   else (height, height))
    by_row(range(first))
    if first < last:
        out[first + 1:last + 1] = _diagonals(filt[first:last],
                                             ftype[first:last], out[first])
    by_row(range(last, height))
    return out[1:]


def decode_png(data: bytes) -> np.ndarray:
    """The image in `data` as (H, W, 4) uint8 RGBA."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if header is None and kind != b"IHDR":
            raise ValueError("PNG: the first chunk is not IHDR")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError("PNG: a transparency chunk is not supported")
        elif kind[0:1].isupper() and kind not in (b"IEND", b"PLTE"):
            raise ValueError(f"PNG: unknown critical chunk {kind!r}")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"PNG: bit depth {depth} and colour type {colour} "
                         f"(only 8-bit RGBA, type 6, and RGB, type 2)")
    if interlace != 0:
        raise ValueError("PNG: interlaced images are not supported")
    if compression != 0 or filtering != 0:
        raise ValueError("PNG: unknown compression or filter method")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG: corrupt image data ({e})") from None
    pixels = _unfilter(raw, height, width, _CHANNELS[colour])
    if colour == 2:
        alpha = np.full((height, width, 1), 255, np.uint8)
        pixels = np.concatenate([pixels, alpha], axis=2)
    return pixels


def read_png(path: str) -> np.ndarray:
    """The PNG at `path` as (1, 4, H, W) uint8 RGBA, the layout the JAX
    package's preprocess_shapenetall.py packs (its process_png_file)."""
    with open(path, "rb") as f:
        pixels = decode_png(f.read())
    return np.ascontiguousarray(np.transpose(pixels, (2, 0, 1))[None])
