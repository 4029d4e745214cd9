"""Dataset image and timestamp reading, and the port's own PNG codec.

``ImageReader`` scans a folder for .png/.jpg/.jpeg/.bmp images (sorted by
name), reads each as 8-bit grey, resizes it to the camera's size, and parses
a timestamp file in the four line formats of the JAX package's reader:

    1. "<stamp> x y z a b c d"     (TUM ground-truth-like, 8 fields)
    2. "<id> <stamp> <exposure>"   (TUM MonoVO times file)
    3. "<id> <stamp>"
    4. "<stamp>"

PNG files are always decoded here, on ``zlib`` and ``struct`` alone, so the
reader needs no OpenCV: 8-bit grey, RGB and RGBA and 16-bit grey, filter
types 0–4, no interlace.  Colour goes to grey as OpenCV's
``IMREAD_GRAYSCALE`` does for a PNG (libpng's fixed-point weights 9797,
19234, 3737 over 2^15, truncated; a pixel with three equal channels keeps
its value), 16-bit grey by dropping the low byte, so both readers give the
same pixels.  Other formats, and the resize to the camera's size, go through
OpenCV when it imports (``INTER_LINEAR``); without it a resize is a
half-pixel-centre bilinear in torch, rounded to the nearest grey level.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: (colour type, bit depth) → samples a pixel, for the layouts this codec reads
_LAYOUTS = {(0, 8): 1, (2, 8): 3, (6, 8): 4, (0, 16): 1}
#: libpng's rgb_to_gray weights for (0.299, 0.587), over 2**15
_GREY_WEIGHTS = (9797, 19234, 3737)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write ``img`` as a PNG: (H, W) uint8 or uint16 grey, (H, W, 3) uint8 RGB,
    (H, W, 4) uint8 RGBA.  Rows are stored unfiltered (filter type 0)."""
    a = np.asarray(img)
    if a.ndim == 2 and a.dtype in (np.uint8, np.uint16):
        ctype = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4) and a.dtype == np.uint8:
        ctype = 2 if a.shape[2] == 3 else 6
    else:
        raise ValueError(f"write_png: unsupported image {a.dtype} {a.shape}")
    depth = 16 if a.dtype == np.uint16 else 8
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8)
    raw = np.zeros((h, 1 + rows.size // h), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def _unfilter_row_sequential(x: list, prev: list, bpp: int, paeth: bool) -> bytearray:
    """One row of filter type 3 (average) or 4 (Paeth): each byte needs the
    decoded byte ``bpp`` to its left."""
    cur = bytearray(len(x))
    for i, v in enumerate(x):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if paeth:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            pred = (a + b) >> 1
        cur[i] = (v + pred) & 0xFF
    return cur


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, the header needs {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    ftype, data = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        raise ValueError(f"PNG filter type {int(ftype.max())} is not one of 0-4")
    if not ftype.any():
        return data.copy()
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for r in range(h):
        x, f = data[r], int(ftype[r])
        if f == 0:
            cur = x
        elif f == 1:
            cur = np.cumsum(x.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif f == 2:
            cur = x + prev
        else:
            cur = np.frombuffer(_unfilter_row_sequential(x.tolist(), prev.tolist(), bpp,
                                                         paeth=f == 4), np.uint8)
        out[r] = cur
        prev = out[r]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: (H, W) uint8 or uint16 grey, (H, W, 3) uint8 RGB or
    (H, W, 4) uint8 RGBA, channels in file order.  Raises ``ValueError`` on
    a layout this codec does not read (palette, grey+alpha, 1/2/4-bit,
    16-bit colour, interlace) and on a damaged file."""
    with open(path, "rb") as fh:
        buf = fh.read()
    if buf[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 12 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        if pos + 12 + n > len(buf):
            raise ValueError(f"{path}: truncated {tag!r} chunk")
        data = buf[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", buf[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + data) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: damaged {tag!r} chunk")
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if (ctype, depth) not in _LAYOUTS:
        raise ValueError(f"{path}: PNG colour type {ctype} at {depth} bits is not supported")
    ch = _LAYOUTS[(ctype, depth)]
    bpp = ch * depth // 8
    out = _unfilter(zlib.decompress(b"".join(idat)), h, w * bpp, bpp)
    if depth == 16:
        return out.view(">u2").astype(np.uint16).reshape(h, w)
    return out.reshape((h, w) if ch == 1 else (h, w, ch))


def to_grey_u8(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as 8-bit grey, as OpenCV's ``IMREAD_GRAYSCALE`` gives it."""
    if img.dtype == np.uint16:
        return (img >> 8).astype(np.uint8)
    if img.ndim == 2:
        return img
    r, g, b = (img[..., k].astype(np.int64) for k in range(3))
    wr, wg, wb = _GREY_WEIGHTS
    grey = (r * wr + g * wg + b * wb) >> 15
    return np.where((r == g) & (r == b), r, grey).astype(np.uint8)


def _cv2():
    """OpenCV, or None where it is not installed."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def resize_bilinear(img: np.ndarray, size_wh: tuple[int, int]) -> np.ndarray:
    """Resize 8-bit grey to ``size_wh`` with half-pixel-centre bilinear
    sampling (the sampling grid of OpenCV's ``INTER_LINEAR``), rounded."""
    import torch                      # here: a reader worker decodes PNG without torch
    import torch.nn.functional as F

    t = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)[None, None]
    out = F.interpolate(t, size=(size_wh[1], size_wh[0]), mode="bilinear",
                        align_corners=False, antialias=False)
    return out[0, 0].round().clamp(0, 255).to(torch.uint8).numpy()


def read_grey(path: str) -> np.ndarray:
    """One image file as (H, W) uint8 grey."""
    if path.lower().endswith(".png"):
        return to_grey_u8(read_png(path))
    cv2 = _cv2()
    if cv2 is None:
        ext = os.path.splitext(path)[1]
        raise RuntimeError(f"reading {ext} images needs OpenCV (cv2), which is not "
                           f"installed; PNG reads without it ({path})")
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise IOError(f"failed to read {path}")
    return img


def read_resized(path: str, size_wh: tuple[int, int]) -> np.ndarray:
    """One image file as (H, W) uint8 grey at ``size_wh``."""
    img = read_grey(path)
    if (img.shape[1], img.shape[0]) != tuple(size_wh):
        cv2 = _cv2()
        if cv2 is None:
            img = resize_bilinear(img, size_wh)
        else:
            img = cv2.resize(img, tuple(size_wh), interpolation=cv2.INTER_LINEAR)
    return img


def list_images(image_folder: str) -> list[str]:
    """The folder's .png/.jpg/.jpeg/.bmp files, sorted by name."""
    exts = (".png", ".jpg", ".jpeg", ".bmp")
    return sorted(os.path.join(image_folder, f) for f in os.listdir(image_folder)
                  if f.lower().endswith(exts))


def _parse_stamp_line(line: str) -> str | None:
    tok = line.split()
    if not tok:
        return None
    if len(tok) >= 8:
        return tok[0]
    if len(tok) in (2, 3):
        return tok[1]
    return tok[0]


class ImageReader:
    def __init__(self, image_folder: str, size_wh: tuple[int, int],
                 time_file: str | None = None):
        self.files = list_images(image_folder)
        self.size_wh = tuple(size_wh)
        self.stamps: list[str] = []
        if time_file and time_file != "None":
            with open(time_file) as fh:
                for line in fh:
                    s = _parse_stamp_line(line)
                    if s is not None:
                        self.stamps.append(s)
        self.stamp_valid = len(self.stamps) >= len(self.files) and len(self.files) > 0

    def __len__(self) -> int:
        return len(self.files)

    def read_image(self, i: int) -> np.ndarray:
        return read_resized(self.files[i], self.size_wh)

    def read_stamp(self, i: int) -> str:
        return self.stamps[i] if self.stamp_valid else str(i)
