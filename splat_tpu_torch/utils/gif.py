"""Animated GIF writer (pure stdlib and NumPy) for orbit trajectories: a
6x7x6 colour cube, 4x4 ordered dithering and LZW, so a trajectory is one
shareable file.  The bytes equal ``splat_tpu.utils.gif.write_gif``'s for
the same frames."""

from __future__ import annotations

import struct

import numpy as np
import torch

_LEVELS = (6, 7, 6)  # 252-entry RGB cube

_BAYER4 = np.array([
    [0, 8, 2, 10],
    [12, 4, 14, 6],
    [3, 11, 1, 9],
    [15, 7, 13, 5],
], np.float32) / 16.0 - 0.5


def _palette() -> np.ndarray:
    lr, lg, lb = _LEVELS
    r = np.linspace(0, 255, lr)
    g = np.linspace(0, 255, lg)
    b = np.linspace(0, 255, lb)
    pal = np.zeros((256, 3), np.uint8)
    idx = 0
    for i in range(lr):
        for j in range(lg):
            for k in range(lb):
                pal[idx] = (r[i], g[j], b[k])
                idx += 1
    return pal


def _quantize(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float [0, 1] -> (H, W) uint8 palette indices, dithered."""
    h, w, _ = img.shape
    lr, lg, lb = _LEVELS
    dither = np.tile(_BAYER4, (h // 4 + 1, w // 4 + 1))[:h, :w]
    out = np.zeros((h, w), np.int32)
    mult = (lg * lb, lb, 1)
    for ch, levels, m in zip(range(3), _LEVELS, mult):
        v = np.clip(img[:, :, ch], 0.0, 1.0) * (levels - 1)
        q = np.clip(np.round(v + dither), 0, levels - 1).astype(np.int32)
        out += q * m
    return out.astype(np.uint8)


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF-flavoured LZW with clear/EOI codes and variable code width."""
    clear = 1 << min_code_size
    eoi = clear + 1
    out = bytearray()
    bitbuf = 0
    bitcnt = 0

    def emit(code: int, width: int):
        nonlocal bitbuf, bitcnt
        bitbuf |= code << bitcnt
        bitcnt += width
        while bitcnt >= 8:
            out.append(bitbuf & 0xFF)
            bitbuf >>= 8
            bitcnt -= 8

    table: dict[bytes, int] = {bytes([i]): i for i in range(clear)}
    next_code = eoi + 1
    width = min_code_size + 1
    emit(clear, width)
    prefix = b""
    for sym in indices.tobytes():
        cand = prefix + bytes([sym])
        if cand in table:
            prefix = cand
            continue
        emit(table[prefix], width)
        table[cand] = next_code
        next_code += 1
        if next_code > (1 << width) and width < 12:
            width += 1
        elif next_code >= 4096:
            emit(clear, width)
            table = {bytes([i]): i for i in range(clear)}
            next_code = eoi + 1
            width = min_code_size + 1
        prefix = bytes([sym])
    if prefix:
        emit(table[prefix], width)
    emit(eoi, width)
    if bitcnt:
        out.append(bitbuf & 0xFF)
    return bytes(out)


def _frame(f) -> np.ndarray:
    if isinstance(f, torch.Tensor):
        f = f.detach().cpu().numpy()
    return np.asarray(f)[..., :3]


def write_gif(path: str, frames, *, fps: float = 20.0,
              loop: bool = True) -> None:
    """Write frames ((F, H, W, 3) or a list of (H, W, 3|4) images, float in
    [0, 1] or uint8, arrays or tensors) as an animated GIF.  GIF has no
    alpha plane, so RGBA frames lose theirs."""
    frames = [_frame(f) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    delay_cs = max(2, int(round(100.0 / fps)))
    pal = _palette()

    with open(path, "wb") as f:
        f.write(b"GIF89a")
        f.write(struct.pack("<HHBBB", w, h, 0xF7, 0, 0))  # 256-colour GCT
        f.write(pal.tobytes())
        if loop:
            f.write(b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00")
        for img in frames:
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            idx = _quantize(img)
            f.write(struct.pack("<BBHB", 0x21, 0xF9, 4, 0x04))  # GCE
            f.write(struct.pack("<HBB", delay_cs, 0, 0))
            f.write(struct.pack("<BHHHHB", 0x2C, 0, 0, w, h, 0))
            f.write(bytes([8]))  # LZW min code size
            data = _lzw_encode(idx)
            for off in range(0, len(data), 255):
                blk = data[off:off + 255]
                f.write(bytes([len(blk)]) + blk)
            f.write(b"\x00")
        f.write(b"\x3b")
