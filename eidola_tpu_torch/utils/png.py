"""PNG codec on the standard library's zlib and numpy (the port's stand-in
for the PIL calls of eidola_tpu: the viewer's and the headless app's
frame encode, the glTF loader's texture decode and load_hdr's fallback).

`encode_png` writes 8-bit RGB or RGBA with the Up filter on every row
(one numpy subtraction for the whole image; zlib releases the
interpreter lock while it compresses).  `decode_png` reads
non-interlaced images in grey, grey+alpha, RGB, RGBA and palette colour
types at 8 bits, grey and palette also at 1, 2 and 4 (grey scaled to
0-255), 16 bits reduced as PIL reduces them when it converts to RGBA (the
high byte, but grey clipped at 255), with all five row filters and a
tRNS chunk; it returns (H, W, 4) uint8 RGBA, as
PIL's `Image.open(...).convert("RGBA")` does.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W, 3|4) uint8 -> PNG bytes, at zlib's fastest level (a viewer
    encodes every frame)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"encode_png takes (H, W, 3|4) uint8, not "
                         f"{img.dtype} {img.shape}")
    h, w, c = img.shape
    rows = img.reshape(h, w * c)
    up = np.empty((h, w * c + 1), np.uint8)
    up[:, 0] = 2                                 # filter type Up
    up[0, 1:] = rows[0]
    np.subtract(rows[1:], rows[:-1], out=up[1:, 1:])   # wraps mod 256
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if c == 4 else 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(up.tobytes(), 1))
            + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec 9.2) -> (h, stride) uint8."""
    data = np.frombuffer(raw, np.uint8)
    if data.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    data = data[:h * (stride + 1)].reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        f, row = int(data[y, 0]), data[y, 1:]
        if f == 0:
            cur = row.copy()
        elif f == 1:        # Sub: a running sum per byte of the pixel
            cur = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:        # Up
            cur = row + prev
        elif f in (3, 4):   # Average, Paeth: byte by byte
            cur = _unfilter_row(f, row.tolist(), prev.tolist(), bpp)
        else:
            raise ValueError(f"PNG row {y} has unknown filter type {f}")
        out[y] = cur
        prev = out[y]
    return out


def _unfilter_row(f: int, row: list, prev: list, bpp: int) -> np.ndarray:
    cur = [0] * len(row)
    for i, x in enumerate(row):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if f == 3:
            cur[i] = (x + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 4) uint8 RGBA."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, idat, plte, trns, hdr = len(SIGNATURE), [], None, None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError("Adam7-interlaced PNG is not supported")
    ch = _CHANNELS.get(ctype)
    if ch is None or depth not in ((1, 2, 4, 8, 16) if ctype == 0 else
                                   (1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"PNG colour type {ctype} at {depth} bits is not "
                         f"a valid PNG")
    stride = (w * ch * depth + 7) // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                   max(ch * depth // 8, 1))
    if depth < 8:
        bits = np.unpackbits(px, axis=1).reshape(h, stride * 8 // depth,
                                                 depth)[:, :w]
        px = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))
              ).sum(-1, dtype=np.uint8)[..., None]
        if ctype == 0:
            raw_grey = px
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        px = px.reshape(h, w, ch * depth // 8)
    if depth == 16:
        wide = (px[..., 0::2].astype(np.uint16) << 8) | px[..., 1::2]
        # PIL opens 16-bit grey as I;16 and clips it; the other types
        # keep their high byte
        px = (np.minimum(wide, 255).astype(np.uint8) if ctype == 0
              else px[..., 0::2])
    out = np.empty((h, w, 4), np.uint8)
    if ctype == 3:
        if plte is None:
            raise ValueError("palette PNG has no PLTE chunk")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        lut = np.zeros((256, 4), np.uint8)
        lut[:plte.shape[0], :3] = plte
        lut[:, 3] = alpha
        return lut[px[..., 0]]
    grey = ctype in (0, 4)
    out[..., :3] = px[..., :1] if grey else px[..., :3]
    out[..., 3] = px[..., -1] if ctype in (4, 6) else 255
    if trns is not None and ctype in (0, 2):
        # a colour key: the samples' full values, compared after the
        # reduction as PIL compares them
        key = np.frombuffer(trns, ">u2").astype(np.int64)
        if depth == 16:
            key = np.minimum(key, 255) if ctype == 0 else key >> 8
        sample = (raw_grey if depth < 8 else out[..., :1]) if grey \
            else out[..., :3]
        out[..., 3] = np.where((sample == key).all(-1), 0, out[..., 3])
    return out
