"""PNG files with numpy and zlib alone.

The port reads Replica's frames (8-bit RGB colour, 16-bit gray depth in
millimetres) and writes the explorer's placeholder assets with this codec:
the machines it runs on need no image library. Formats: 8-bit gray, RGB and
RGBA, and 16-bit gray (big-endian samples), non-interlaced. Anything else
(palette, gray with alpha, other bit depths, Adam7 interlace) raises a
`ValueError` that names the file.

Decoding undoes each row's filter (PNG spec §9: None, Sub, Up, Avg, Paeth).
None, Sub and Up are row-parallel: Sub is a running sum mod 256 in each
byte lane, Up one add per row. Avg and Paeth read the reconstructed byte to
the left, so a run of rows holding them is reconstructed along
anti-diagonals: pixel (r, c) needs only (r, c-1), (r-1, c) and (r-1, c-1),
all on earlier diagonals, so each of the rows + columns - 1 steps does one
vector operation over the pixels of a diagonal.

Encoding takes each row's filter from the caller (one filter for every row,
or one per row), so every decode path can be written on purpose.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVG, PAETH = range(5)
FILTERS = ("none", "sub", "up", "avg", "paeth")
# (colour type, bit depth) -> channels.
_FORMATS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha", 6: "RGBA"}


def read_png(path: str) -> np.ndarray:
    """The image in `path`: uint8 [H, W] (gray), [H, W, 3] (RGB) or
    [H, W, 4] (RGBA); uint16 [H, W] for 16-bit gray."""
    with open(path, "rb") as f:
        return decode_png(f.read(), name=path)


def read_rgb(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8 RGB [H, W, 3]: gray spread to three channels,
    alpha dropped (what cv2.imread's colour mode gives, in RGB order)."""
    image = read_png(path)
    if image.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit image, got {image.dtype}")
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    return np.ascontiguousarray(image[:, :, :3])


def write_png(path: str, image: np.ndarray, filters: Union[int, Sequence[int]] = SUB) -> None:
    """Write `image` (see `encode_png`) to `path`."""
    data = encode_png(image, filters)
    with open(path, "wb") as f:
        f.write(data)


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode the bytes of a PNG file; `name` labels the errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated (no IEND chunk)")
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        crc = data[pos + 8 + length : pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {kind.decode('latin-1')} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{name}: CRC mismatch in the {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{name}: no IHDR chunk")
    width, height, depth, color, compression, filter_method, interlace = header
    if (color, depth) not in _FORMATS:
        raise ValueError(
            f"{name}: {depth}-bit {_COLOR_NAMES.get(color, f'colour type {color}')} PNGs are not supported "
            "(8-bit gray, RGB and RGBA, and 16-bit gray are)"
        )
    if interlace != 0:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if compression != 0 or filter_method != 0:
        raise ValueError(f"{name}: unknown compression {compression} or filter method {filter_method}")
    channels = _FORMATS[(color, depth)]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"{name}: {len(raw)} bytes of image data, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, dtype=np.uint8).reshape(height, stride + 1)
    kinds = rows[:, 0]
    if height and int(kinds.max()) > PAETH:
        raise ValueError(f"{name}: unknown row filter {int(kinds.max())}")
    pixels = unfilter(rows[:, 1:], kinds, bpp)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(height, width)
    return pixels.reshape((height, width) if channels == 1 else (height, width, channels))


def encode_png(image: np.ndarray, filters: Union[int, Sequence[int]] = SUB) -> bytes:
    """PNG bytes of uint8 [H, W], [H, W, 3] or [H, W, 4], or uint16 [H, W].
    `filters`: the filter of every row (NONE, SUB, UP, AVG or PAETH), or a
    sequence of one per row."""
    image = np.asarray(image)
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    if image.dtype == np.uint16 and image.ndim == 2:
        color, depth, rows = 0, 16, image.astype(">u2").view(np.uint8).reshape(height, 2 * width)
    elif image.dtype == np.uint8 and channels in _COLOR_TYPE:
        color, depth, rows = _COLOR_TYPE[channels], 8, image.reshape(height, width * channels)
    else:
        raise ValueError(f"cannot write a {image.dtype} image of shape {image.shape} as PNG")
    kinds = np.broadcast_to(np.asarray(filters, dtype=np.uint8), (height,))
    if height and int(kinds.max()) > PAETH:
        raise ValueError(f"unknown row filter {int(kinds.max())}")
    filtered = filter_rows(rows, kinds, channels * depth // 8)
    raw = np.concatenate([kinds[:, None], filtered], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")


def _neighbours(x: np.ndarray, bpp: int):
    """(a, b, c) of every byte of x [H, stride] as int16: left, up, up-left
    (zero outside the image)."""
    x = x.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:] = a[:-1]
    return a, b, c


def _predictor(kind: int, a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Filter `kind`'s prediction of each byte from its left (a), upper (b)
    and upper-left (c) neighbours, int16 arrays; None predicts 0."""
    if kind == SUB:
        return a
    if kind == UP:
        return b
    if kind == AVG:
        return (a + b) >> 1
    p, q = b - c, a - c  # Paeth: the neighbour nearest a + b - c, ties to a, then b
    pa, pb, pc = np.abs(p), np.abs(q), np.abs(p + q)
    take_a = (pa <= pb) & (pa <= pc)
    return c + take_a * q + (~take_a & (pb <= pc)) * p


def filter_rows(x: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Filter uint8 rows x [H, stride]: row r by filter kinds[r]."""
    a, b, c = _neighbours(x, bpp)
    out = x.astype(np.int16)
    for kind in (SUB, UP, AVG, PAETH):
        r = kinds == kind
        if r.any():
            out[r] -= _predictor(kind, a[r], b[r], c[r])
    return (out & 0xFF).astype(np.uint8)


def unfilter(f: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Reconstruct uint8 rows [H, stride] from filtered rows f and their
    filters: row-parallel outside the band of rows from the first Avg or
    Paeth row to the last, along anti-diagonals inside it."""
    height, stride = f.shape
    x = np.empty_like(f)
    hard = np.flatnonzero(kinds >= AVG)
    first, last = (int(hard[0]), int(hard[-1]) + 1) if hard.size else (height, height)
    _unfilter_rows(f, kinds, x, 0, first, bpp)
    if first < last:
        prior = x[first - 1] if first else np.zeros(stride, np.uint8)
        x[first:last] = _unfilter_diagonals(f[first:last], kinds[first:last], prior, bpp)
    _unfilter_rows(f, kinds, x, last, height, bpp)
    return x


def _unfilter_rows(f, kinds, x, r0: int, r1: int, bpp: int) -> None:
    """Rows r0..r1-1, none of them Avg or Paeth, one vector step each."""
    for r in range(r0, r1):
        kind = kinds[r]
        if kind == NONE:
            x[r] = f[r]
        elif kind == SUB:
            x[r] = np.cumsum(f[r].reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif r:  # UP
            np.add(f[r], x[r - 1], out=x[r])
        else:
            x[r] = f[r]


def _unfilter_diagonals(f: np.ndarray, kinds: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Rows f [n, stride] of any filters below the reconstructed row `prior`,
    along anti-diagonals of pixels.

    The skewed arrays hold diagonal after diagonal, contiguous: row k is
    `prior` (k = 0) or band row k - 1, and pixel (k, c) sits at
    [k + c + 1, k], so that the left of column 0 reads as zeros. A step
    reads diagonals i - 1 and i - 2 and writes diagonal i. A row's
    prediction sums the predictors of the filters present, each weighted 0
    or 1 by the row's filter (cheaper per step than a select)."""
    n, stride = f.shape
    w = stride // bpp
    rows = np.arange(1, n + 1)[:, None]
    diag = rows + np.arange(w)[None, :] + 1
    fd = np.zeros((n + w + 1, n + 1, bpp), np.int16)
    fd[diag, rows] = f.reshape(n, w, bpp)
    y = np.zeros_like(fd)
    y[np.arange(1, w + 1), 0] = prior.reshape(w, bpp)
    kinds = np.concatenate([[NONE], kinds])
    present = [kind for kind in (SUB, UP, AVG, PAETH) if (kinds[1:] == kind).any()]
    weights = None
    if len(present) > 1 or (kinds[1:] == NONE).any():
        weights = {kind: np.repeat((kinds == kind).astype(np.int16)[:, None], bpp, axis=1) for kind in present}
    for i in range(2, n + w + 1):  # diagonal i holds rows max(1, i-w)..min(n, i-1)
        lo, hi = max(1, i - w), min(n, i - 1) + 1
        a, b, c = y[i - 1, lo:hi], y[i - 1, lo - 1 : hi - 1], y[i - 2, lo - 1 : hi - 1]
        pred = fd[i, lo:hi]
        for kind in present:
            term = _predictor(kind, a, b, c)
            pred = pred + (term if weights is None else weights[kind][lo:hi] * term)
        np.bitwise_and(pred, 0xFF, out=y[i, lo:hi])
    return y[diag, rows].astype(np.uint8).reshape(n, stride)
