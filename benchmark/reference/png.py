"""A PNG writer and reader of the benchmark's own: 8-bit RGB and 16-bit
gray, every row with filter 0. The benchmark writes its input frames with
it; the program reads them with its own loader, the reference with this."""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_png", "read_png"]

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def write_png(path: str, img: np.ndarray) -> None:
    """``(h, w, 3)`` uint8 as RGB, or ``(h, w)`` uint16 as 16-bit gray."""
    if img.dtype == np.uint8 and img.ndim == 3 and img.shape[2] == 3:
        depth, color, rows = 8, 2, img
    elif img.dtype == np.uint16 and img.ndim == 2:
        depth, color, rows = 16, 0, img.astype(">u2")
    else:
        raise ValueError(f"write_png takes (h, w, 3) uint8 or (h, w) uint16, not {img.dtype} {img.shape}")
    h, w = img.shape[:2]
    raw = np.ascontiguousarray(rows).view(np.uint8).reshape(h, -1)
    data = np.concatenate([np.zeros((h, 1), np.uint8), raw], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(data, 1)) + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read back a file of :func:`write_png`."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos : pos + 4])
        kind, data = buf[pos + 4 : pos + 8], buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
    w, h, depth, color = header[:4]
    channels = 3 if color == 2 else 1
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a row with a filter other than 0")
    px = rows[:, 1:]
    if depth == 16:
        px = px.copy().view(">u2").astype(np.uint16)
    return px.reshape(h, w, channels) if channels == 3 else px.reshape(h, w)
