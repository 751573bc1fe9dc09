"""The zlib PNG codec (pyrite_tpu/png.py): what the CLI writes and the
texture loader reads, with no imaging library."""

import struct
import zlib

import numpy as np
import pytest

from pyrite_tpu import png
from pyrite_tpu.project.textures import load_texture


def _chunks(data):
    pos, out = 8, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        out.append((kind, body, crc))
        pos += 12 + length
    return out


def test_writer_signature_header_and_crcs(tmp_path):
    image = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    path = tmp_path / "out.png"
    png.write_png(str(path), image)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    chunks = _chunks(data)
    assert [k for k, _, _ in chunks] == [b"IHDR", b"IDAT", b"IEND"]
    for kind, body, crc in chunks:
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc
    width, height, depth, color, comp, filt, interlace = struct.unpack(
        ">IIBBBBB", chunks[0][1]
    )
    assert (width, height, depth, color) == (7, 5, 8, 2)
    assert (comp, filt, interlace) == (0, 0, 0)


@pytest.mark.parametrize(
    "shape, dtype",
    [
        ((6, 9, 3), np.uint8),  # RGB
        ((6, 9, 4), np.uint8),  # RGBA
        ((6, 9), np.uint8),  # gray
        ((6, 9, 2), np.uint8),  # gray + alpha
        ((6, 9, 3), np.uint16),  # 16-bit RGB
    ],
)
def test_round_trip(shape, dtype):
    rng = np.random.default_rng(1)
    image = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype)
    back = png.decode_png(png.encode_png(image))
    assert back.dtype == dtype
    np.testing.assert_array_equal(back.reshape(shape), image)


def _filtered_png(image, filters):
    """8-bit RGB PNG whose row y uses filter filters[y % len(filters)]."""
    h, w, c = image.shape
    rows = image.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        kind = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(kind)
        raw.extend(((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        png.SIGNATURE
        + png._chunk(b"IHDR", header)
        + png._chunk(b"IDAT", zlib.compress(bytes(raw)))
        + png._chunk(b"IEND", b"")
    )


def test_reader_undoes_every_row_filter():
    image = np.random.default_rng(2).integers(0, 256, (10, 6, 3), np.uint8)
    data = _filtered_png(image, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(png.decode_png(data), image)


def test_reader_rejects_what_it_does_not_decode():
    data = bytearray(png.encode_png(np.zeros((2, 2, 3), np.uint8)))
    with pytest.raises(png.PNGError, match="signature"):
        png.decode_png(b"GIF89a" + bytes(data[6:]))
    palette = png.SIGNATURE + png._chunk(
        b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 3, 0, 0, 0)
    )
    with pytest.raises(png.PNGError, match="color type 3"):
        png.decode_png(palette)
    data[-5] ^= 0xFF  # corrupt the IEND CRC
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode_png(bytes(data))


def test_texture_loader_reads_png(tmp_path):
    path = tmp_path / "tex.png"
    image = np.zeros((2, 3, 4), np.uint8)
    image[..., 0] = 255
    image[..., 3] = 128
    png.write_png(str(path), image)
    tex = load_texture(str(path), linear=True, mono=False).data
    assert tex.shape == (2, 3, 4)
    np.testing.assert_allclose(tex[..., 0], 1.0)
    np.testing.assert_allclose(tex[..., 3], 128 / 255, rtol=1e-6)
    gray = load_texture(str(path), linear=True, mono=True).data
    np.testing.assert_allclose(gray, 0.2126, rtol=1e-5)
