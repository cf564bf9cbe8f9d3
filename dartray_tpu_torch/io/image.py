"""Image files: PNG (a zlib writer and reader), PFM, Radiance HDR and TGA
(counterpart of the JAX reference's ``io/image.py``, numpy only).

Output is gamma 2.2 tonemapped PNG or linear PFM; ``load`` decodes any of the
four formats to (H, W, 3) float32 linear RGB.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

GAMMA = 2.2  # output_image.dart:57-66


def tonemap(rgb: np.ndarray, gamma: float = GAMMA) -> np.ndarray:
    """Linear RGB -> 8-bit sRGB-ish gamma (toImage semantics)."""
    x = np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) ** (1.0 / gamma)
    return (x * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, rgb8: np.ndarray):
    """Minimal RGB8 PNG writer (no deps)."""
    h, w = rgb8.shape[:2]
    if rgb8.ndim == 2:
        rgb8 = np.repeat(rgb8[:, :, None], 3, axis=2)
    raw = b"".join(b"\x00" + rgb8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return (struct.pack(">I", len(data)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xffffffff))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def write_pfm(path: str, rgb: np.ndarray):
    """Float HDR dump (PFM, little-endian)."""
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(np.asarray(rgb, np.float32)[::-1].tobytes())


def read_pfm(data: bytes) -> np.ndarray:
    parts = data.split(b"\n", 3)
    hdr = parts[0].strip()
    w, h = map(int, parts[1].split())
    scale = float(parts[2])
    img = np.frombuffer(parts[3], dtype=("<f4" if scale < 0 else ">f4"))
    ch = 3 if hdr == b"PF" else 1
    img = img[: w * h * ch].reshape(h, w, ch)[::-1]
    if ch == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img.astype(np.float32))


def read_hdr(data: bytes) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder (new-style RLE)."""
    pos = data.index(b"\n\n") if b"\n\n" in data else data.index(b"\r\n\r\n")
    header, rest = data[:pos], data[pos:].lstrip(b"\r\n")
    nl = rest.index(b"\n")
    dims = rest[:nl].split()
    h, w = int(dims[1]), int(dims[3])
    raw = rest[nl + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    p = 0
    for y in range(h):
        if len(raw) - p >= 4 and raw[p] == 2 and raw[p + 1] == 2 \
                and (raw[p + 2] << 8 | raw[p + 3]) == w:
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    n = raw[p]
                    p += 1
                    if n > 128:
                        rgbe[y, x:x + n - 128, c] = raw[p]
                        p += 1
                        x += n - 128
                    else:
                        rgbe[y, x:x + n, c] = np.frombuffer(
                            raw[p:p + n], np.uint8)
                        p += n
                        x += n
        else:  # flat RGBE
            row = np.frombuffer(raw[p:p + 4 * w], np.uint8).reshape(w, 4)
            rgbe[y] = row
            p += 4 * w
    f = np.ldexp(rgbe[..., :3].astype(np.float32) + 0.5,
                 rgbe[..., 3:4].astype(np.int32) - 136)
    f[rgbe[..., 3] == 0] = 0.0
    return f


def read_png(data: bytes) -> np.ndarray:
    """Minimal PNG decoder: 8-bit RGB/RGBA/gray, non-interlaced."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bitdepth = ctype = None
    while pos < len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bitdepth, ctype = struct.unpack(">IIBB", chunk[:10])
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
        pos += 12 + ln
    assert bitdepth == 8, "only 8-bit PNG supported"
    nch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    raw = zlib.decompress(idat)
    stride = w * nch
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for y in range(h):
        ft = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(
            np.int32)
        p += 1 + stride
        if ft == 1:   # sub
            for x in range(nch, stride):
                row[x] = (row[x] + row[x - nch]) & 0xFF
        elif ft == 2:  # up
            row = (row + prev) & 0xFF
        elif ft == 3:  # average
            for x in range(stride):
                left = row[x - nch] if x >= nch else 0
                row[x] = (row[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ft == 4:  # paeth
            for x in range(stride):
                a = row[x - nch] if x >= nch else 0
                b = prev[x]
                c = prev[x - nch] if x >= nch else 0
                pp = a + b - c
                pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                row[x] = (row[x] + pred) & 0xFF
        img[y] = row.astype(np.uint8)
        prev = row
    img = img.reshape(h, w, nch)
    if nch == 1:
        img = np.repeat(img, 3, axis=2)
    elif nch == 2:
        img = np.repeat(img[..., :1], 3, axis=2)
    elif nch == 4:
        img = img[..., :3]
    # sRGB-ish gamma decode to linear (image_texture gamma handling)
    return (img.astype(np.float32) / 255.0) ** GAMMA


def read_tga(data: bytes) -> np.ndarray:
    """Minimal uncompressed/RLE true-color TGA decoder."""
    idlen = data[0]
    imgtype = data[2]
    w = data[12] | (data[13] << 8)
    h = data[14] | (data[15] << 8)
    bpp = data[16] // 8
    desc = data[17]
    p = 18 + idlen
    n = w * h
    px = np.zeros((n, bpp), np.uint8)
    if imgtype == 2:
        px = np.frombuffer(data[p:p + n * bpp], np.uint8).reshape(n, bpp)
    elif imgtype == 10:
        i = 0
        while i < n:
            hdr = data[p]
            p += 1
            cnt = (hdr & 0x7F) + 1
            if hdr & 0x80:
                px[i:i + cnt] = np.frombuffer(data[p:p + bpp], np.uint8)
                p += bpp
            else:
                px[i:i + cnt] = np.frombuffer(
                    data[p:p + cnt * bpp], np.uint8).reshape(cnt, bpp)
                p += cnt * bpp
            i += cnt
    else:
        raise ValueError(f"unsupported TGA type {imgtype}")
    img = px.reshape(h, w, bpp)
    if not (desc & 0x20):
        img = img[::-1]
    rgb = img[..., :3][..., ::-1]  # BGR -> RGB
    return (rgb.astype(np.float32) / 255.0) ** GAMMA


def load(data: bytes, name: str = "") -> np.ndarray:
    """Decode image bytes -> (H, W, 3) float32 linear RGB."""
    if data[:2] in (b"PF", b"Pf"):
        return read_pfm(data)
    if data[:2] == b"#?":
        return read_hdr(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return read_png(data)
    if name.lower().endswith(".tga"):
        return read_tga(data)
    raise ValueError(f"unsupported image format for {name!r}")


def save(path: str, rgb_linear):
    rgb = np.asarray(rgb_linear)
    if path.endswith(".pfm"):
        write_pfm(path, rgb)
    else:
        write_png(path, tonemap(rgb))
