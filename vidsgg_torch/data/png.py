"""A PNG reader for Action Genome's frames, in NumPy and ``zlib``.

It stands where ``vidsgg`` calls ``cv2.imread(path, cv2.IMREAD_UNCHANGED)``
and returns what that call returns for AG's frames: ``[H, W, 3] uint8`` in
BGR order. It reads 8-bit RGB, non-interlaced PNGs with any of the five row
filters, checks every chunk's CRC, and raises ``ValueError`` naming the
field on anything else (another colour type or bit depth, interlacing, a
``tRNS`` transparency): the loader's 3-channel mean subtraction needs three
8-bit channels.

Rows are unfiltered in order, since each row's filter reads the row above.
None, Sub and Up are whole-row NumPy operations; Avg and Paeth read the
byte just decoded to their left, so they run as a Python loop along the
row (the slowest part of a decode).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_BPP = 3    # bytes per pixel of 8-bit RGB


def _chunks(data: bytes):
    """(type, payload) of every chunk, CRCs checked."""
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated chunk header")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"PNG: truncated {kind!r} chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: CRC mismatch in the {kind.decode('latin-1')} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG: no IEND chunk")


def _header(body: bytes):
    if len(body) != 13:
        raise ValueError("PNG: IHDR has the wrong length")
    width, height, depth, color, compression, filt, interlace = struct.unpack(">IIBBBBB", body)
    if depth != 8:
        raise ValueError(f"PNG: IHDR bit depth {depth} is not supported (8 only)")
    if color != 2:
        raise ValueError(f"PNG: IHDR colour type {color} is not supported (2, RGB, only)")
    if interlace != 0:
        raise ValueError(f"PNG: IHDR interlace method {interlace} is not supported (0 only)")
    if compression != 0 or filt != 0:
        raise ValueError(f"PNG: IHDR compression {compression} / filter method {filt} "
                         "is not supported (0 only)")
    if width == 0 or height == 0:
        raise ValueError("PNG: IHDR has a zero width or height")
    return width, height


def _avg_row(raw: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = raw.tolist()
    up = prev.tolist()
    for i in range(_BPP):
        out[i] = (out[i] + (up[i] >> 1)) & 0xFF
    for i in range(_BPP, len(out)):
        out[i] = (out[i] + ((out[i - _BPP] + up[i]) >> 1)) & 0xFF
    return np.array(out, np.uint8)


def _paeth_row(raw: np.ndarray, prev: np.ndarray) -> np.ndarray:
    out = raw.tolist()
    up = prev.tolist()
    for i in range(_BPP):   # a = c = 0: the predictor is b
        out[i] = (out[i] + up[i]) & 0xFF
    for i in range(_BPP, len(out)):
        a, b, c = out[i - _BPP], up[i], up[i - _BPP]
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.array(out, np.uint8)


def unfilter(filtered: np.ndarray, height: int, stride: int) -> np.ndarray:
    """[height, 1 + stride] filtered scanlines -> [height, stride] bytes."""
    rows = filtered.reshape(height, 1 + stride)
    kinds = rows[:, 0]
    data = rows[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = int(kinds[y]), data[y]
        if kind == 0:
            row = raw
        elif kind == 1:
            row = np.cumsum(raw.reshape(-1, _BPP), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            row = raw + prev
        elif kind == 3:
            row = _avg_row(raw, prev)
        elif kind == 4:
            row = _paeth_row(raw, prev)
        else:
            raise ValueError(f"PNG: scanline {y} has filter type {kind} (0-4 only)")
        out[y] = row
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8, BGR."""
    if not data.startswith(SIGNATURE):
        raise ValueError("PNG: bad signature")
    size = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            size = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            raise ValueError("PNG: tRNS transparency is not supported (3 channels only)")
    if size is None:
        raise ValueError("PNG: no IHDR chunk")
    if not idat:
        raise ValueError("PNG: no IDAT chunk")
    width, height = size
    stride = width * _BPP
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + stride):
        raise ValueError(f"PNG: IDAT holds {raw.size} bytes, want {height * (1 + stride)}")
    rgb = unfilter(raw, height, stride).reshape(height, width, _BPP)
    return np.ascontiguousarray(rgb[:, :, ::-1])


def read_png(path) -> np.ndarray:
    """The frame at ``path`` -> [H, W, 3] uint8, BGR."""
    with open(path, "rb") as f:
        return decode_png(f.read())
