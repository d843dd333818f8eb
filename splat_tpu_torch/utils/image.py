"""Image utilities: PSNR, PNG writing and reading, and supersampling's box
filter."""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


def _as_numpy(img) -> np.ndarray:
    if isinstance(img, torch.Tensor):
        return img.detach().cpu().numpy()
    return np.asarray(img)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def to_uint8(img) -> np.ndarray:
    return (np.clip(_as_numpy(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(img, *, level: int = 6) -> bytes:
    """(H, W, 3) RGB or (H, W, 4) RGBA, uint8 or float in [0, 1] -> PNG."""
    img = _as_numpy(img)
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    h, w, c = img.shape
    if c not in (3, 4):
        raise ValueError(f"expected 3 or 4 channels, got {c}")
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img, *, level: int = 6) -> None:
    """Write an image as PNG (see :func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(img, level=level))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA PNG (filter types 0-4) as (H, W, 3|4)
    uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = bitdepth = coltype = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, coltype = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if bitdepth != 8 or coltype not in (2, 6):
        raise ValueError(f"unsupported PNG (depth={bitdepth}, color={coltype})")
    nch = 3 if coltype == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * nch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    off = 0
    for y in range(h):
        ftype = raw[off]
        row = np.frombuffer(raw[off + 1:off + 1 + stride],
                            np.uint8).astype(np.int32)
        off += 1 + stride
        if ftype == 0:
            cur = row
        elif ftype == 2:  # up
            cur = (row + prev) & 0xFF
        else:  # sub / average / paeth reconstruct left to right
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = cur[i - nch] if i >= nch else 0
                b = prev[i]
                c = prev[i - nch] if i >= nch else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:  # paeth
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c)
                cur[i] = (row[i] + pred) & 0xFF
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, nch)


def psnr(a, b, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB between two float images."""
    a = _as_numpy(a)
    b = _as_numpy(b)
    if a.dtype == np.uint8 or b.dtype == np.uint8:
        raise ValueError("convert to float before psnr")
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range * data_range / mse))


def box_downsample(img, k: int):
    """Average k x k pixel blocks: (H*k, W*k, C) -> (H, W, C).  Takes a
    tensor or a NumPy array and returns the same kind."""
    if k == 1:
        return img
    hk, wk, c = img.shape
    if hk % k or wk % k:
        raise ValueError(f"image {tuple(img.shape)} not divisible by "
                         f"supersample factor {k}")
    blocks = img.reshape(hk // k, k, wk // k, k, c)
    if isinstance(img, torch.Tensor):
        return blocks.mean(dim=(1, 3))
    return blocks.mean(axis=(1, 3))
