"""The port's baseline-JPEG decoder (`utils/jpeg.py`) against PIL's decode
of the same files, written here with PIL (which the port never imports).

The bound. PIL decodes through libjpeg with its defaults: the integer
"islow" IDCT, fancy (triangle) chroma upsampling and fixed-point YCbCr ->
RGB. The port does the same upsampling and colour conversion in the same
integer arithmetic, so only the IDCT differs: it rounds the exact
(float64) IDCT, and islow's samples are within one level of that (its
accuracy meets IEEE 1180's peak error of 1). So each component sample
differs by at most 1. The upsampling filters are weighted sums whose
weights add to one, rounded once, so a one-level input difference stays
at most one level. The colour conversion then adds, for each output, its
inputs' differences times the magnitudes of their JFIF constants, plus
one level for the two outputs' roundings:
  - R = Y + 1.402 Cr': 1 + 1.402 + 1 < 4, so |dR| <= 3;
  - G = Y - 0.34414 Cb' - 0.71414 Cr': 1 + 0.344 + 0.714 + 1 < 4, |dG| <= 3;
  - B = Y + 1.772 Cb': 1 + 1.772 + 1 < 4, |dB| <= 3;
  - gray: |dY| <= 1.
Tolerance: max |diff| 3 per colour channel, 1 for gray, and a mean |diff|
per channel under 0.2: a sample moves only where islow's rounding differs
from the exact IDCT's, which these files measured at means of 0.014-0.062.
"""

import io

import numpy as np
import pytest
from PIL import Image

from nerf_workspaces_explorer_tpu_torch.utils import jpeg

MAX_DIFF_COLOR = 3
MAX_DIFF_GRAY = 1
MEAN_DIFF = 0.2


def _image(h, w, seed=0):
    """A smooth pattern with noise: every frequency band has content."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 7.0), 128 + 90 * np.cos(y / 5.0 + x / 11.0), (x * 3 + y * 5) % 256], -1)
    noise = np.random.default_rng(seed).normal(0, 20, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _encode(image, mode, **kw):
    buf = io.BytesIO()
    Image.fromarray(image).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _check(data, mode, tmp_path):
    path = tmp_path / "asset.jpg"
    path.write_bytes(data)
    ref = np.asarray(Image.open(io.BytesIO(data)).convert("RGB")).astype(int)
    mine = jpeg.read_rgb(str(path))
    assert mine.dtype == np.uint8 and mine.shape == ref.shape
    diff = np.abs(mine.astype(int) - ref)
    worst = MAX_DIFF_GRAY if mode == "L" else MAX_DIFF_COLOR
    assert diff.max() <= worst, diff.reshape(-1, 3).max(0)
    assert diff.reshape(-1, 3).mean(0).max() < MEAN_DIFF, diff.reshape(-1, 3).mean(0)
    if mode == "L":
        gray = jpeg.read_jpeg(str(path))
        assert gray.ndim == 2 and np.array_equal(mine, np.repeat(gray[:, :, None], 3, 2))


SAMPLINGS = {"gray": ("L", 0), "444": ("RGB", 0), "422": ("RGB", 1), "420": ("RGB", 2)}


@pytest.mark.parametrize("size", [(23, 37), (48, 64)], ids=["37x23", "64x48"])
@pytest.mark.parametrize("quality", [50, 95])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_decode_matches_pil(sampling, quality, size, tmp_path):
    """Gray and 4:4:4 / 4:2:2 / 4:2:0 colour at two qualities, at an odd
    size (partial MCUs on both axes, odd chroma widths) and a whole one."""
    mode, sub = SAMPLINGS[sampling]
    data = _encode(_image(*size), mode, quality=quality, subsampling=sub)
    _check(data, mode, tmp_path)


@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_restart_intervals(sampling, tmp_path):
    """DRI with an RSTn every two MCUs: the DC predictions restart."""
    mode, sub = SAMPLINGS[sampling]
    data = _encode(_image(23, 37, seed=1), mode, quality=80, subsampling=sub, restart_marker_blocks=2)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _check(data, mode, tmp_path)


def test_extended_sequential_16bit_tables_and_comment(tmp_path):
    """A quantization table above 255 makes libjpeg write 16-bit tables
    and SOF1; a COM segment is skipped."""
    q = [list(range(1, 65)), [300] * 64]
    data = _encode(_image(23, 37, seed=2), "RGB", qtables=q, subsampling=2, comment=b"a comment")
    assert b"\xff\xc1" in data and b"\xff\xfe" in data
    _check(data, "RGB", tmp_path)


def _patched(data, marker_from, marker_to):
    i = data.index(bytes([0xFF, marker_from]))
    return data[:i + 1] + bytes([marker_to]) + data[i + 2:]


@pytest.mark.parametrize("kind", ["progressive", "lossless", "arithmetic", "12-bit", "cmyk"])
def test_unsupported_kinds_raise_naming_the_file(kind, tmp_path):
    image = _image(16, 16)
    if kind == "progressive":
        data = _encode(image, "RGB", progressive=True)
    elif kind == "cmyk":
        data = _encode(image, "CMYK")
    else:
        data = _encode(image, "RGB")
        if kind == "lossless":
            data = _patched(data, 0xC0, 0xC3)
        elif kind == "arithmetic":
            data = _patched(data, 0xC0, 0xC9)
        else:
            i = data.index(b"\xff\xc0")
            data = data[:i + 4] + bytes([12]) + data[i + 5:]
    path = tmp_path / f"{kind}.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"{kind}.jpg"):
        jpeg.read_rgb(str(path))


def test_not_a_jpeg_raises(tmp_path):
    path = tmp_path / "plan.jpg"
    path.write_bytes(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="plan.jpg: not a JPEG"):
        jpeg.read_rgb(str(path))


def test_fancy_upsampling_is_libjpegs():
    """The triangle filter's integer arithmetic on a ramp and at the edges
    (jdsample.c: h2v1 (3a + b + 1 or 2) >> 2, h2v2 (3 colsum + colsum' + 8
    or 7) >> 4, edge samples replicated)."""
    x = np.array([[0, 100, 200]])
    np.testing.assert_array_equal(jpeg.fancy_upsample(x, 2, 1), [[0, 25, 75, 125, 175, 200]])
    y = np.array([[0, 160], [80, 240]])
    up = jpeg.fancy_upsample(y, 2, 2)
    # Row 0 takes colsums 3 * row0 + row0 (the edge replicated) = [0, 640],
    # row 1 takes 3 * row0 + row1 = [80, 720]; then (3 c + c_left + 8) >> 4
    # and (3 c + c_right + 7) >> 4.
    np.testing.assert_array_equal(up[0], [0, 40, 120, 160])
    np.testing.assert_array_equal(up[1], [20, 60, 140, 180])
    assert up.shape == (4, 4)
