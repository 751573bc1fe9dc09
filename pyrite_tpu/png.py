"""Minimal PNG encoder and decoder on ``zlib`` + ``struct``.

The writer emits non-interlaced 8- or 16-bit gray, gray+alpha, RGB or RGBA
images with filter type 0 on every row. The reader decodes the same color
types at 8 or 16 bits with any of the five row filters; palette images,
other bit depths and interlaced files raise ``PNGError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# channels -> PNG color type (gray, gray+alpha, RGB, RGBA)
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


class PNGError(ValueError):
    pass


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + kind
        + data
        + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)
    )


def encode_png(image: np.ndarray) -> bytes:
    """[H, W] or [H, W, C] (C in 1..4) uint8/uint16 array -> PNG bytes."""
    image = np.asarray(image)
    if image.ndim == 2:
        image = image[:, :, None]
    if image.ndim != 3 or image.shape[2] not in _COLOR_TYPES:
        raise PNGError(f"cannot encode an image of shape {image.shape}")
    if image.dtype == np.uint8:
        depth = 8
    elif image.dtype == np.uint16:
        depth = 16
        image = image.astype(">u2")
    else:
        raise PNGError(f"cannot encode dtype {image.dtype}; use uint8 or uint16")
    height, width, channels = image.shape
    rows = np.ascontiguousarray(image).reshape(height, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    header = struct.pack(
        ">IIBBBBB", width, height, depth, _COLOR_TYPES[channels], 0, 0, 0
    )
    return (
        SIGNATURE
        + _chunk(b"IHDR", header)
        + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(image))


def _unfilter_slow(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows depend on the reconstructed left
    neighbour, so they are undone byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 or uint16 array (C = 1..4)."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file (bad signature)")
    pos = 8
    header = None
    idat = []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        kind = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length : pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise PNGError(f"CRC mismatch in {kind.decode('latin-1')} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise PNGError("PNG has no IHDR chunk")
    width, height, depth, color_type, _, _, interlace = header
    if color_type not in _CHANNELS:
        raise PNGError(
            f"unsupported PNG color type {color_type} (palette images are not "
            "decoded; supported: gray, gray+alpha, RGB, RGBA)"
        )
    if depth not in (8, 16):
        raise PNGError(f"unsupported PNG bit depth {depth} (supported: 8, 16)")
    if interlace:
        raise PNGError("interlaced PNGs are not supported")
    channels = _CHANNELS[color_type]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise PNGError("PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(rows[y, 0])
        line = rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            # Sub: a running byte sum along each of the bpp byte lanes
            lanes = line.reshape(width, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise PNGError(f"bad PNG row filter {kind}")
        out[y] = cur
        prev = out[y]
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(height, width, channels)
    return out.reshape(height, width, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        return decode_png(fh.read())
