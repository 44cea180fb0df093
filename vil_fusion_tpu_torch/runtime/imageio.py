"""PNG decoding and encoding on zlib and numpy.

The JAX package reads dataset images with PIL (`Image.open(path).convert("L")`,
vil_fusion_tpu/runtime/datasets.py) and draws its plots with matplotlib;
the port runs where neither is installed, so it carries this codec.

Decoding covers what the datasets ship: bit depth 8 with colour types 0
(grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA), and 16-bit grey, with all
five scanline filters. `read_grey` converts to 8-bit grey exactly as PIL's
`convert("L")`: RGB(A) as (19595 R + 38470 G + 7471 B + 0x8000) >> 16, the
alpha channel dropped, 16-bit grey clipped to 255. Interlaced images, other
bit depths and palettes raise NotImplementedError with the file's name.

The encoder writes the same five colour layouts with one filter for every
row (the smoke run's dataset fixtures and the plots of runtime/viz.py).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOUR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type


def _paeth(a, b, c):
    """PNG's Paeth predictor, elementwise on int arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int, name: str):
    """Undo one scanline's filter (uint8 arrays of the row's bytes)."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: a running sum over each byte of the pixel, mod 256
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return row + prior
    if ftype not in (3, 4):
        raise ValueError(f"{name}: unknown PNG filter type {ftype}")
    # Avg and Paeth depend on the decoded byte to the left: a serial scan
    out = row.tolist()
    up = prior.tolist()
    if ftype == 3:
        for i in range(len(out)):
            left = out[i - bpp] if i >= bpp else 0
            out[i] = (out[i] + ((left + up[i]) >> 1)) & 0xFF
    else:
        for i in range(len(out)):
            if i >= bpp:
                a, c = out[i - bpp], up[i - bpp]
            else:
                a = c = 0
            b = up[i]
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """Samples of a PNG: (H, W) for grey, (H, W, C) otherwise; uint8, or
    uint16 for 16-bit grey."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    off, idat, hdr = 8, [], None
    while off + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[off:off + 8])
        body = data[off + 8:off + 8 + n]
        off += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise NotImplementedError(f"{name}: interlaced PNG is not decoded")
    if ctype not in _CHANNELS or not (depth == 8 or (depth == 16 and ctype == 0)):
        raise NotImplementedError(f"{name}: PNG colour type {ctype} at bit depth {depth} "
                                  f"is not decoded (8-bit grey, RGB, grey+alpha, RGBA and "
                                  f"16-bit grey are)")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(h):
        prior = out[r] = _unfilter_row(int(rows[r, 0]), rows[r, 1:], prior, bpp, name)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def to_grey(img: np.ndarray) -> np.ndarray:
    """8-bit grey as PIL's convert("L") gives it from the decoded samples."""
    if img.ndim == 2:
        return np.minimum(img, 255).astype(np.uint8) if img.dtype == np.uint16 else img
    if img.shape[-1] == 2:  # grey + alpha: the alpha is dropped
        return np.ascontiguousarray(img[..., 0])
    rgb = img[..., :3].astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


def read_grey(path: str) -> np.ndarray:
    """(H, W) uint8 grey image of a PNG file."""
    return to_grey(read_png(path))


def _filter(x: np.ndarray, ftype: int, bpp: int) -> np.ndarray:
    """Filter every row of x (h, stride) uint8 with one filter type."""
    xi = x.astype(np.int32)
    up = np.zeros_like(xi)
    up[1:] = xi[:-1]
    left = np.zeros_like(xi)
    left[:, bpp:] = xi[:, :-bpp]
    upleft = np.zeros_like(xi)
    upleft[:, bpp:] = up[:, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) >> 1, 4: _paeth(left, up, upleft)}[ftype]
    return ((xi - pred) & 0xFF).astype(np.uint8)


def encode_png(img: np.ndarray, filter_type: int = 2) -> bytes:
    """PNG bytes of (H, W) uint8 / uint16 grey or (H, W, C) uint8 with C = 2
    (grey + alpha), 3 (RGB) or 4 (RGBA); every row filtered with
    `filter_type` (0 none, 1 Sub, 2 Up, 3 Avg, 4 Paeth)."""
    img = np.asarray(img)
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type {filter_type} is not one of 0-4")
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ch = 16, 1
        data = img.astype(">u2").view(np.uint8).reshape(img.shape[0], -1)
    elif img.dtype == np.uint8 and (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (2, 3, 4))):
        depth, ch = 8, 1 if img.ndim == 2 else img.shape[2]
        data = np.ascontiguousarray(img).reshape(img.shape[0], -1)
    else:
        raise ValueError(f"cannot encode an array of shape {img.shape} and dtype {img.dtype}")
    h, w = img.shape[:2]
    filt = _filter(data, filter_type, ch * depth // 8)
    rows = np.concatenate([np.full((h, 1), filter_type, np.uint8), filt], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes())) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, filter_type: int = 2):
    with open(path, "wb") as f:
        f.write(encode_png(img, filter_type))
