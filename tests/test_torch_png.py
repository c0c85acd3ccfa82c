"""The port's PNG codec (`utils/png.py`) against cv2, PIL and imageio: its
decoder on files they write, their decoders on files it writes with each
row filter forced, and the formats it refuses. Every comparison is exact."""

import io
import time

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from nerf_workspaces_explorer_tpu_torch.utils import png

WIDTHS = [1, 7, 640]
KINDS = ["gray", "rgb", "rgba", "gray16"]


def _image(kind, width, seed=0, height=5):
    rng = np.random.default_rng(seed)
    shape = {"gray": (height, width), "rgb": (height, width, 3), "rgba": (height, width, 4),
             "gray16": (height, width)}[kind]
    if kind == "gray16":
        return rng.integers(0, 65536, shape, dtype=np.uint16)
    # A smooth ramp plus noise: the writers' adaptive filters then pick
    # other filters than on pure noise.
    ramp = (np.arange(width)[None, :] * 3 + np.arange(height)[:, None] * 5).astype(np.int64)
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    return ((ramp + rng.integers(0, 12, shape)) % 256).astype(np.uint8)


def _write_cv2(path, image):
    if image.ndim == 3:  # cv2 writes BGR(A)
        image = image[:, :, [2, 1, 0, 3][: image.shape[2]]]
    assert cv2.imwrite(str(path), image)


def _write_pil(path, image):
    Image.fromarray(image).save(str(path))


def _write_imageio(path, image):
    imageio.imwrite(str(path), image)


@pytest.mark.parametrize("writer", [_write_cv2, _write_pil, _write_imageio], ids=["cv2", "PIL", "imageio"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_decodes_what_the_libraries_write(tmp_path, writer, width, kind):
    image = _image(kind, width, seed=width)
    path = tmp_path / "x.png"
    writer(path, image)
    out = png.read_png(str(path))
    assert out.dtype == image.dtype and out.shape == image.shape
    np.testing.assert_array_equal(out, image)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("filt", list(png.FILTERS) + ["mixed"])
def test_encoder_filters_read_back_by_pil_and_cv2(tmp_path, kind, filt):
    image = _image(kind, 33, seed=3, height=9)
    filters = np.arange(9) % 5 if filt == "mixed" else png.FILTERS.index(filt)
    data = png.encode_png(image, filters)
    raw = png.decode_png(data)
    np.testing.assert_array_equal(raw, image)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    read = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    if read.ndim == 3:
        read = read[:, :, [2, 1, 0, 3][: read.shape[2]]]
    np.testing.assert_array_equal(read, image)


def test_filters_are_the_ones_asked_for():
    """Each row's filter byte is the caller's; the decoder reconstructs each."""
    import zlib

    image = _image("rgb", 16, seed=1, height=10)
    filters = [4, 3, 3, 0, 1, 2, 4, 4, 1, 3]
    data = png.encode_png(image, filters)
    start = data.index(b"IDAT") + 4
    length = int.from_bytes(data[start - 8 : start - 4], "big")
    raw = np.frombuffer(zlib.decompress(data[start : start + length]), np.uint8).reshape(10, -1)
    assert raw[:, 0].tolist() == filters
    np.testing.assert_array_equal(png.decode_png(data), image)


def test_cv2_writes_sub_rows_at_replica_size(tmp_path):
    """cv2 writes every row of a 640x480 frame with the Sub filter: the
    decoder's row-parallel path."""
    import zlib

    image = _image("rgb", 640, height=480)
    path = tmp_path / "x.png"
    _write_cv2(path, image)
    data = path.read_bytes()
    idat = b""
    pos = 8
    while pos < len(data):
        length = int.from_bytes(data[pos : pos + 4], "big")
        if data[pos + 4 : pos + 8] == b"IDAT":
            idat += data[pos + 8 : pos + 8 + length]
        pos += 12 + length
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(480, -1)
    assert set(rows[:, 0].tolist()) == {png.SUB}
    np.testing.assert_array_equal(png.read_png(str(path)), image)


def _save_interlaced(img, path):
    """An Adam7 PNG: cv2 and PIL do not write one, so patch the interlace
    byte of IHDR (the decoder must refuse it before reading pixels)."""
    import struct
    import zlib

    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = bytearray(buf.getvalue())
    data[8 + 8 + 12] = 1  # IHDR body byte 12: interlace method
    crc = zlib.crc32(bytes(data[12 : 8 + 8 + 13]))
    data[8 + 8 + 13 : 8 + 8 + 17] = struct.pack(">I", crc)
    with open(path, "wb") as f:
        f.write(bytes(data))


@pytest.mark.parametrize(
    "save,match",
    [
        (_save_interlaced, "interlaced"),
        (lambda img, p: img.convert("P").save(p), "palette"),
        (lambda img, p: img.convert("LA").save(p), "gray\\+alpha"),
        (lambda img, p: img.convert("1").save(p), "1-bit"),
        (lambda img, p: cv2.imwrite(p, np.zeros((4, 4, 3), np.uint16)), "16-bit RGB"),
    ],
    ids=["interlaced", "palette", "gray_alpha", "1bit", "rgb16"],
)
def test_unsupported_files_raise_naming_the_file(tmp_path, save, match):
    img = Image.fromarray(_image("rgb", 8, height=8))
    path = str(tmp_path / "bad.png")
    save(img, path)
    with pytest.raises(ValueError, match=match) as err:
        png.read_png(path)
    assert path in str(err.value)


def test_corrupt_files_raise(tmp_path):
    data = bytearray(png.encode_png(_image("rgb", 8)))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a" + bytes(data[6:]), name="a.gif")
    data[45] ^= 0xFF  # a byte inside IDAT
    with pytest.raises(ValueError, match="CRC mismatch"):
        png.decode_png(bytes(data))
    with pytest.raises(ValueError, match="truncated"):
        png.decode_png(bytes(data[:30]))
    with pytest.raises(ValueError, match="cannot write"):
        png.encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError, match="row filter"):
        png.encode_png(np.zeros((4, 4), np.uint8), 5)


def test_every_filter_round_trips_at_replica_size():
    """One 640x480 RGB frame through each filter and mixed rows, exactly;
    the decode seconds print with -s (this machine's CPU). Avg and Paeth
    take the anti-diagonal path."""
    image = _image("rgb", 640, height=480)
    for name, filters in [*((n, i) for i, n in enumerate(png.FILTERS)), ("mixed", np.arange(480) % 5)]:
        data = png.encode_png(image, filters)
        t0 = time.perf_counter()
        out = png.decode_png(data)
        print(f"decode 640x480 RGB, {name} rows: {time.perf_counter() - t0:.4f} s")
        np.testing.assert_array_equal(out, image)
