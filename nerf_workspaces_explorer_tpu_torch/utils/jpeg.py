"""Baseline JPEG files with numpy alone.

The Tk explorer shows the reference's `.jpg` assets (floor plans and
thumbnails) through this decoder: the machines the port runs on have no
image library. It reads sequential Huffman-coded files (SOF0 baseline and
SOF1 extended) with 8-bit samples and one component (gray) or three (YCbCr,
as JFIF), the luma sampled 1x1, 2x1 or 2x2 against the chroma (4:4:4,
4:2:2, 4:2:0), with 8- or 16-bit quantization tables, restart intervals
(DRI, RSTn), one interleaved scan or one scan a component. APPn and COM
segments are skipped. Progressive, lossless, hierarchical and arithmetic-
coded files, 12-bit samples and CMYK or other component counts raise a
`ValueError` that names the file, as `utils/png.py` does for what it does
not read.

Decoding: Huffman codes through a 9-bit peek table, longer codes through
the canonical code's per-length limits; dequantization; the IDCT as two
batched float64 matrix products over all blocks of a component, rounded to
8-bit samples; chroma upsampled by libjpeg's "fancy" triangle filter (what
PIL's decode does); YCbCr -> RGB by JFIF's constants in libjpeg's 16-bit
fixed point. The only arithmetic that differs from libjpeg's default decode
is its integer IDCT, whose samples are within one level of the rounded
exact IDCT computed here (`tests/test_torch_jpeg.py` derives the bound on
the RGB output from that).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np

# Natural (row-major) index of each zigzag position: diagonals of constant
# row + column, odd ones walked down-left, even ones up-right.
ZIGZAG = np.array(sorted(range(64), key=lambda k: (k // 8 + k % 8, k // 8 if (k // 8 + k % 8) % 2 else -(k // 8))))
PEEK_BITS = 9
# IDCT basis: f = M F M^T for an 8x8 block F of dequantized coefficients.
_IDCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5 * np.cos((2 * x + 1) * u * np.pi / 16)
                   for u in range(8)] for x in range(8)])
# Marker codes (ITU T.81 table B.1).
EOI, SOS, DQT, DHT, DRI, COM = 0xD9, 0xDA, 0xDB, 0xC4, 0xDD, 0xFE
_SOF_READ = {0xC0: "baseline", 0xC1: "extended sequential"}
_SOF_REFUSED = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "hierarchical", 0xC6: "hierarchical progressive",
    0xC7: "hierarchical lossless", 0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical progressive", 0xCF: "arithmetic-coded hierarchical lossless",
}
# Luma sampling (H, V) against 1x1 chroma that the decoder upsamples.
SAMPLINGS = ((1, 1), (2, 1), (2, 2))


class _Huffman:
    """A canonical Huffman table: `peek[w]` for the next PEEK_BITS bits w is
    (code length << 8 | symbol), or 0 when the code is longer; then
    `maxcode`, `mincode` and `first` per length (ITU T.81 F.2.2.3)."""

    def __init__(self, counts: List[int], symbols: bytes, name: str) -> None:
        self.peek = [0] * (1 << PEEK_BITS)
        self.maxcode = [-1] * 17
        self.mincode = [0] * 17
        self.first = [0] * 17
        self.symbols = symbols
        code = k = 0
        for length in range(1, 17):
            n = counts[length - 1]
            self.first[length], self.mincode[length] = k, code
            for _ in range(n):
                if code >= 1 << length:
                    raise ValueError(f"{name}: invalid Huffman table")
                if length <= PEEK_BITS:
                    shift = PEEK_BITS - length
                    entry = (length << 8) | symbols[k]
                    for j in range(code << shift, (code + 1) << shift):
                        self.peek[j] = entry
                code += 1
                k += 1
            if n:
                self.maxcode[length] = code - 1
            code <<= 1


class _Component(NamedTuple):
    ident: int
    h: int
    v: int
    qtable: int


def read_jpeg(path: str) -> np.ndarray:
    """The image in `path`: uint8 [H, W] (gray) or [H, W, 3] (RGB)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), name=path)


def read_rgb(path: str) -> np.ndarray:
    """A JPEG as uint8 RGB [H, W, 3], gray spread to three channels."""
    image = read_jpeg(path)
    if image.ndim == 2:
        image = np.repeat(image[:, :, None], 3, axis=2)
    return image


def _segments(data: bytes, start: int, name: str) -> Tuple[List[bytes], int]:
    """The entropy-coded data of a scan from `start`, unstuffed (FF00 ->
    FF) and split at its restart markers, and the offset of the marker that
    ends it."""
    segments, current, i = [], bytearray(), start
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= len(data):
            raise ValueError(f"{name}: truncated scan")
        current += data[i:j]
        nxt = data[j + 1]
        if nxt == 0x00:
            current.append(0xFF)
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segments.append(bytes(current))
            current, i = bytearray(), j + 2
        elif nxt == 0xFF:
            i = j + 1  # a fill byte before a marker
        else:
            segments.append(bytes(current))
            return segments, j


def _decode_scan(segments, blocks, dc, ac, outs, restart, name):
    """Decode one scan's MCUs. `blocks` lists, per MCU, its blocks as
    (component slot, flat block index); every nonzero coefficient lands in
    the slot's (indices, values) lists of `outs` as block * 64 + zigzag
    position."""
    n_slots = len(dc)
    preds = [0] * n_slots
    seg, buf, pos = 0, segments[0] + b"\0\0\0\0", 0
    for m, mcu in enumerate(blocks):
        if restart and m and m % restart == 0:
            if pos > 8 * (len(buf) - 4):
                raise ValueError(f"{name}: truncated restart interval")
            seg += 1
            if seg >= len(segments):
                raise ValueError(f"{name}: missing restart marker")
            buf, pos, preds = segments[seg] + b"\0\0\0\0", 0, [0] * n_slots
        for slot, block in mcu:
            # DC: the size category, then its bits, as a difference.
            table = dc[slot]
            w = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 4], "big") << (pos & 7)) & 0xFFFFFFFF
            e = table.peek[w >> (32 - PEEK_BITS)]
            if e:
                pos += e >> 8
                s = e & 0xFF
            else:
                pos, s = _slow_symbol(table, w, pos, name)
            if s:
                w = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 4], "big") << (pos & 7)) & 0xFFFFFFFF
                v = w >> (32 - s)
                pos += s
                if v < 1 << (s - 1):
                    v -= (1 << s) - 1
                preds[slot] += v
            idx, val = outs[slot]
            base = block * 64
            if preds[slot]:
                idx.append(base)
                val.append(preds[slot])
            # AC: (run, size) symbols up to end of block.
            table = ac[slot]
            k = 1
            while k < 64:
                w = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 4], "big") << (pos & 7)) & 0xFFFFFFFF
                e = table.peek[w >> (32 - PEEK_BITS)]
                if e:
                    pos += e >> 8
                    rs = e & 0xFF
                else:
                    pos, rs = _slow_symbol(table, w, pos, name)
                s = rs & 15
                if s:
                    k += rs >> 4
                    if k > 63:
                        raise ValueError(f"{name}: coefficient run past the block's end")
                    w = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 4], "big") << (pos & 7)) & 0xFFFFFFFF
                    v = w >> (32 - s)
                    pos += s
                    if v < 1 << (s - 1):
                        v -= (1 << s) - 1
                    idx.append(base + k)
                    val.append(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break  # end of block
    if pos > 8 * (len(buf) - 4):
        raise ValueError(f"{name}: truncated scan")


def _slow_symbol(table: _Huffman, w: int, pos: int, name: str) -> Tuple[int, int]:
    """A code longer than PEEK_BITS: (new bit position, symbol)."""
    for length in range(PEEK_BITS + 1, 17):
        code = w >> (32 - length)
        if code <= table.maxcode[length]:
            return pos + length, table.symbols[table.first[length] + code - table.mincode[length]]
    raise ValueError(f"{name}: invalid Huffman code")


def _idct_plane(coef: np.ndarray, qtable: np.ndarray, bh: int, bw: int) -> np.ndarray:
    """[bh * bw * 64] zigzag coefficients -> uint8 samples [8 bh, 8 bw]."""
    natural = np.zeros((bh * bw, 64), np.float64)
    natural[:, ZIGZAG] = coef.reshape(-1, 64) * qtable
    f = _IDCT @ natural.reshape(-1, 8, 8) @ _IDCT.T
    samples = np.clip(np.floor(f + 128.5), 0, 255).astype(np.uint8)
    return samples.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)


def _upsample_h2(x: np.ndarray, bias_even: int, bias_odd: int, shift: int) -> np.ndarray:
    """Double the columns by the triangle filter: (3 x[c] + x[c -/+ 1] +
    bias) >> shift, edge samples replicated."""
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
    out[:, 0::2] = (3 * x + left + bias_even) >> shift
    out[:, 1::2] = (3 * x + right + bias_odd) >> shift
    return out


def fancy_upsample(plane: np.ndarray, h: int, v: int) -> np.ndarray:
    """libjpeg's fancy upsampling of a chroma plane by (h, v) in {(1, 1),
    (2, 1), (2, 2)} (jdsample.c h2v1_fancy_upsample, h2v2_fancy_upsample):
    each output sample weighs its nearest input 3/4 and the next nearer
    1/4 along each doubled axis, edges replicated, in libjpeg's integer
    rounding."""
    x = plane.astype(np.int64)
    if (h, v) == (1, 1):
        return x
    if (h, v) == (2, 1):
        return _upsample_h2(x, 1, 2, 2)
    above = np.concatenate([x[:1], x[:-1]], 0)
    below = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
    out[0::2] = _upsample_h2(3 * x + above, 8, 7, 4)
    out[1::2] = _upsample_h2(3 * x + below, 8, 7, 4)
    return out


def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """JFIF YCbCr -> RGB (R = Y + 1.402 Cr', G = Y - 0.34414 Cb' - 0.71414
    Cr', B = Y + 1.772 Cb', with C' = C - 128) in libjpeg's 16-bit fixed
    point (jdcolor.c), clipped to [0, 255]: uint8 [..., 3]."""
    y, cb, cr = (a.astype(np.int64) for a in (y, cb, cr))
    cb, cr, half = cb - 128, cr - 128, 1 << 15
    r = y + ((_fix(1.40200) * cr + half) >> 16)
    g = y + ((-_fix(0.34414) * cb - _fix(0.71414) * cr + half) >> 16)
    b = y + ((_fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode a baseline JPEG (see the module note): uint8 [H, W] or [H, W, 3]."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    qtables: Dict[int, np.ndarray] = {}
    huffman: Dict[Tuple[int, int], _Huffman] = {}
    comps: List[_Component] = []
    height = width = 0
    restart = 0
    coefs: Dict[int, Tuple[list, list]] = {}
    grid: Dict[int, Tuple[int, int]] = {}  # component -> (block rows, block columns) allocated
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError(f"{name}: truncated or corrupt marker at byte {pos}")
        marker = data[pos + 1]
        if marker == EOI:
            break
        if pos + 4 > len(data):
            raise ValueError(f"{name}: truncated segment {marker:#04x}")
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        body = data[pos + 4:pos + 2 + length]
        if len(body) != length - 2:
            raise ValueError(f"{name}: truncated segment {marker:#04x}")
        pos += 2 + length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{name}: {_SOF_REFUSED[marker]} JPEG is not supported (baseline or extended "
                             f"sequential Huffman only)")
        if marker in _SOF_READ:
            precision, height, width, n = body[0], int.from_bytes(body[1:3], "big"), \
                int.from_bytes(body[3:5], "big"), body[5]
            if precision != 8:
                raise ValueError(f"{name}: {precision}-bit samples are not supported (8-bit only)")
            if n not in (1, 3):
                raise ValueError(f"{name}: {n} components (CMYK or other) are not supported (gray or YCbCr)")
            if height == 0 or width == 0:
                raise ValueError(f"{name}: image size {width}x{height} (a DNL height) is not supported")
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4, body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(n)]
            if n == 1:
                comps = [comps[0]._replace(h=1, v=1)]  # one component: its sampling factors do not matter
            elif (comps[0].h, comps[0].v) not in SAMPLINGS or any((c.h, c.v) != (1, 1) for c in comps[1:]):
                raise ValueError(f"{name}: sampling {[(c.h, c.v) for c in comps]} is not supported "
                                 f"(4:4:4, 4:2:2 or 4:2:0)")
            hmax, vmax = comps[0].h, comps[0].v
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                grid[c.ident] = (mcuy * c.v, mcux * c.h)
                coefs[c.ident] = ([], [])
        elif marker == DQT:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq == 0:
                    q = np.frombuffer(body, np.uint8, 64, i + 1)
                    i += 65
                elif pq == 1:
                    q = np.frombuffer(body, ">u2", 64, i + 1)
                    i += 129
                else:
                    raise ValueError(f"{name}: quantization table precision {pq}")
                qtables[tq] = q.astype(np.float64)
        elif marker == DHT:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                symbols = body[i + 17:i + 17 + sum(counts)]
                huffman[(tc, th)] = _Huffman(counts, symbols, name)
                i += 17 + sum(counts)
        elif marker == DRI:
            restart = int.from_bytes(body[0:2], "big")
        elif marker == SOS:
            if not comps:
                raise ValueError(f"{name}: scan before the frame header")
            ns = body[0]
            by_id = {c.ident: c for c in comps}
            scan = [(by_id[body[1 + 2 * i]], body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15) for i in range(ns)]
            ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if (ss, se, a) != (0, 63, 0):
                raise ValueError(f"{name}: spectral selection {ss}-{se}/{a:#x} (a progressive scan)")
            try:
                dc = [huffman[(0, td)] for _, td, _ in scan]
                ac = [huffman[(1, ta)] for _, _, ta in scan]
            except KeyError as e:
                raise ValueError(f"{name}: scan refers to a missing Huffman table {e}") from None
            segments, pos = _segments(data, pos, name)
            hmax, vmax = comps[0].h, comps[0].v
            if ns == 1:
                # Non-interleaved: one block an MCU, over the component's own blocks.
                c = scan[0][0]
                cw, ch = -(-width * c.h // hmax), -(-height * c.v // vmax)
                cols = grid[c.ident][1]
                blocks = [[(0, r * cols + q)] for r in range(-(-ch // 8)) for q in range(-(-cw // 8))]
            else:
                mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
                blocks = [[(slot, (my * c.v + dv) * grid[c.ident][1] + mx * c.h + dh)
                           for slot, (c, _, _) in enumerate(scan) for dv in range(c.v) for dh in range(c.h)]
                          for my in range(mcuy) for mx in range(mcux)]
            _decode_scan(segments, blocks, dc, ac, [coefs[c.ident] for c, _, _ in scan], restart, name)
        elif marker == COM or 0xE0 <= marker <= 0xEF:
            pass  # APPn and comments
        elif marker in (0xC8, 0xCC, 0xDC, 0xDE, 0xDF):
            raise ValueError(f"{name}: marker {marker:#04x} is not supported")
    if not comps:
        raise ValueError(f"{name}: no frame header")
    hmax, vmax = comps[0].h, comps[0].v
    planes = []
    for c in comps:
        if c.qtable not in qtables:
            raise ValueError(f"{name}: missing quantization table {c.qtable}")
        bh, bw = grid[c.ident]
        flat = np.zeros(bh * bw * 64, np.float64)
        idx, val = coefs[c.ident]
        flat[np.asarray(idx, np.int64)] = np.asarray(val, np.float64)
        plane = _idct_plane(flat, qtables[c.qtable], bh, bw)
        plane = plane[: -(-height * c.v // vmax), : -(-width * c.h // hmax)]
        planes.append(fancy_upsample(plane, hmax // c.h, vmax // c.v)[:height, :width])
    if len(planes) == 1:
        return planes[0].astype(np.uint8)
    return ycc_to_rgb(*planes)
