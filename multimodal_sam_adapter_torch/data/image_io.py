"""PNG files without OpenCV or PIL: the port's counterpart of every
`cv2.imread` and `cv2.imwrite` in the JAX package (its data pipelines,
MUSES's submission files, the visualisation and the inference API).

`imread(path, mode)` gives what the JAX package's OpenCV (opencv-python 5.0
on libpng 1.6) gives for a PNG file, bit for bit
(tests/test_torch_image_io.py):

- `"color"` (IMREAD_COLOR): uint8 (H, W, 3) BGR. Gray is replicated,
  alpha dropped (tRNS too), a palette expanded (indices past its end read
  black), samples of fewer than 8 bits scaled to 8 (x 255 / (2^d - 1)),
  16-bit samples cut to their high byte.
- `"unchanged"` (IMREAD_UNCHANGED): gray as (H, W); gray + alpha as BGRA
  (gray replicated); RGB as BGR, or BGRA when a tRNS chunk names a colour
  key (alpha 0 there, the maximum elsewhere); a palette as BGR, or BGRA
  with the tRNS alphas (255 past their end); RGBA as BGRA. 16-bit samples
  stay uint16; fewer than 8 bits are scaled to 8.

Every bit depth (1, 2, 4, 8, 16), colour type (0, 2, 3, 4, 6) and Adam7
interlacing is read; "color" turns the image by an eXIf chunk's
orientation, as OpenCV does. Each chunk's CRC is checked (zlib.crc32)
and IDAT is inflated with zlib; the scanlines are unfiltered in the host
core (csrc/host/image_core.cpp via data/native.py), whose numpy twin is
`unfilter_numpy`. A missing file raises FileNotFoundError; a file that is
not PNG (a JPEG, say), a bad CRC, a truncated file or stream, an unknown
critical chunk or a malformed header raise `PNGError`, naming the path and
the reason. Not read: other formats, and OpenCV's IMREAD_GRAYSCALE.

`imwrite(path, img, filters=...)` writes uint8 (H, W), (H, W, 3) BGR or
(H, W, 4) BGRA as an 8-bit PNG that `cv2.imread` decodes to the same
array; `filters` picks the row filter (0 None, 1 Sub, 2 Up, 3 Average,
4 Paeth), one for every row or a sequence taken row by row in turn.
"""
from __future__ import annotations

import struct
import zlib
from typing import Iterator, Sequence, Tuple, Union

import numpy as np

from . import native as _native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
MODES = ("color", "unchanged")
# channels of each colour type, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
_CRITICAL = (b"IHDR", b"PLTE", b"IDAT", b"IEND")
# Adam7 passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


class PNGError(ValueError):
    """A file that cannot be read as PNG: the message names the path and
    the reason."""

    def __init__(self, path, reason: str):
        super().__init__(f"{path}: {reason}")
        self.path, self.reason = str(path), reason


# ---------------------------------------------------------------------------
# scanline filters: host core and numpy twin
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_numpy(scan: np.ndarray, bpp: int) -> np.ndarray:
    """(h, 1 + rowbytes) uint8 scanlines -> (h, rowbytes) raw rows, the
    arithmetic of msa_png_unfilter; an unknown filter type raises
    ValueError."""
    h, n = scan.shape[0], scan.shape[1] - 1
    out = np.zeros((h, n), np.uint8)
    prev = np.zeros(n, np.int32)
    for y in range(h):
        ft, line = int(scan[y, 0]), scan[y, 1:].astype(np.int32)
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = line.copy()
            for j in range(min(bpp, n)):
                cur[j::bpp] = np.cumsum(line[j::bpp]) & 255
        elif ft == 2:
            cur = (line + prev) & 255
        elif ft in (3, 4):
            cur = np.zeros(n, np.int32)
            for i in range(0, n, bpp):
                sl = slice(i, min(i + bpp, n))
                k = sl.stop - i
                left = cur[i - bpp:i - bpp + k] if i else np.zeros(k, np.int32)
                up = prev[sl]
                if ft == 3:
                    pred = (left + up) >> 1
                else:
                    ul = (prev[i - bpp:i - bpp + k] if i
                          else np.zeros(k, np.int32))
                    pred = _paeth(left, up, ul)
                cur[sl] = (line[sl] + pred) & 255
        else:
            raise ValueError(f"row {y}: unknown filter type {ft}")
        out[y] = cur
        prev = cur
    return out


def unfilter_native(scan: np.ndarray, bpp: int) -> np.ndarray:
    """`unfilter_numpy` in the host core."""
    lib = _native.load_native()
    scan = np.ascontiguousarray(scan, np.uint8)
    h, n = scan.shape[0], scan.shape[1] - 1
    out = np.empty((h, n), np.uint8)
    bad = lib.msa_png_unfilter(scan.ctypes.data_as(_native._U8P), h, n, bpp,
                               out.ctypes.data_as(_native._U8P))
    if bad:
        raise ValueError(f"row {bad - 1}: unknown filter type "
                         f"{int(scan[bad - 1, 0])}")
    return out


def filter_rows(raw: np.ndarray, bpp: int,
                filters: Union[int, Sequence[int]]) -> np.ndarray:
    """(h, rowbytes) raw rows -> (h, 1 + rowbytes) scanlines, row y taking
    filters[y % len(filters)] (the predictors read the raw bytes, so every
    type is one numpy expression)."""
    h, n = raw.shape
    ft = np.resize(np.asarray([filters] if np.isscalar(filters)
                              else filters, np.uint8), h)
    if ft.size and ft.max() > 4:
        raise ValueError(f"filter types are 0-4, not {ft.max()}")
    out = np.empty((h, n + 1), np.uint8)
    out[:, 0] = ft
    for f in np.unique(ft):
        rows = np.flatnonzero(ft == f)
        x = raw[rows].astype(np.int16)
        if f == 0:
            out[rows, 1:] = raw[rows]
            continue
        up = np.where((rows > 0)[:, None], raw[rows - 1], 0).astype(np.int16)
        left = np.zeros_like(x)
        left[:, bpp:] = x[:, :-bpp]
        if f == 1:
            pred = left
        elif f == 2:
            pred = up
        elif f == 3:
            pred = (left + up) >> 1
        else:
            ul = np.zeros_like(x)
            ul[:, bpp:] = up[:, :-bpp]
            pred = _paeth(left, up, ul)
        out[rows, 1:] = (x - pred).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _chunks(data: bytes, path) -> Iterator[Tuple[bytes, bytes]]:
    if not data.startswith(SIGNATURE):
        kind = " (a JPEG)" if data[:3] == b"\xff\xd8\xff" else ""
        raise PNGError(path, f"not a PNG file{kind}: it starts with "
                             f"{data[:8]!r}")
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise PNGError(path, f"truncated: no chunk header at byte {pos} "
                                 f"of {len(data)}, and no IEND")
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 12 + n
        if end > len(data):
            raise PNGError(path, f"truncated: chunk {ctype!r} of {n} bytes "
                                 f"at byte {pos} runs past the end "
                                 f"({len(data)} bytes)")
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:end])[0]
        if zlib.crc32(ctype + body) != crc:
            raise PNGError(path, f"bad CRC in chunk {ctype!r} at byte {pos}")
        if not ctype.isalpha():
            raise PNGError(path, f"malformed chunk type {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end


def _header(body: bytes, path):
    if len(body) != 13:
        raise PNGError(path, f"IHDR of {len(body)} bytes, not 13")
    w, h, depth, color, comp, filt, lace = struct.unpack(">IIBBBBB", body)
    if w == 0 or h == 0 or w > 2 ** 31 - 1 or h > 2 ** 31 - 1:
        raise PNGError(path, f"image size {w}x{h}")
    if color not in _DEPTHS or depth not in _DEPTHS[color]:
        raise PNGError(path, f"bit depth {depth} with colour type {color}")
    if comp or filt or lace > 1:
        raise PNGError(path, f"compression {comp}, filter method {filt}, "
                             f"interlace {lace}")
    return w, h, depth, color, lace


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """(h, rowbytes) raw rows -> (h, w, ch) samples (uint8 or uint16)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.reshape(h, -1).view(">u2")[:, :w * ch].astype(np.uint16)
    elif depth == 8:
        s = rows[:, :w * ch]
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        s = (bits * weights).sum(-1, dtype=np.uint8)[:, :w * ch]
    return s.reshape(h, w, ch)


def _inflate(data: bytes, path):
    """(IHDR's (w, h, depth, colour type, interlace), {b"PLTE": palette,
    b"tRNS": bytes, b"eXIf": bytes} as found, the inflated IDAT stream) of
    the PNG file `data`."""
    head, extra, idat = None, {}, []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            head = _header(body, path)
        elif head is None:
            raise PNGError(path, f"chunk {ctype!r} before IHDR")
        elif ctype == b"PLTE":
            if len(body) % 3 or not 0 < len(body) <= 768:
                raise PNGError(path, f"PLTE of {len(body)} bytes")
            extra[ctype] = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype in (b"tRNS", b"eXIf"):
            extra[ctype] = body
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype[0] & 0x20 == 0 and ctype not in _CRITICAL:
            raise PNGError(path, f"unknown critical chunk {ctype!r}")
    if not idat:
        raise PNGError(path, "no IDAT chunk")
    if head[3] == 3 and b"PLTE" not in extra:
        raise PNGError(path, "palette image without PLTE")
    z = zlib.decompressobj()
    try:
        stream = z.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(path, f"corrupt image data: {e}") from None
    if not z.eof:
        raise PNGError(path, "truncated image data: the zlib stream ends "
                             "early")
    return head, extra, stream


def _pass_size(rowbytes: int, rows: int, pos: int, stream: bytes, path):
    size = rows * (rowbytes + 1)
    if pos + size > len(stream):
        raise PNGError(path, f"truncated image data: {len(stream)} bytes "
                             f"inflated, the image needs more")
    return size


def png_scanlines(data: bytes, path="<bytes>") -> Tuple[np.ndarray, int]:
    """The filtered scanlines (h, 1 + rowbytes) of a non-interlaced PNG
    file and its bytes a pixel: what `unfilter_native` and
    `unfilter_numpy` take."""
    (w, h, depth, color, lace), _, stream = _inflate(data, path)
    if lace:
        raise ValueError(f"{path}: interlaced; its passes are decoded "
                         f"apart")
    ch = _CHANNELS[color]
    rowbytes = (w * ch * depth + 7) // 8
    size = _pass_size(rowbytes, h, 0, stream, path)
    return (np.frombuffer(stream, np.uint8, size).reshape(h, -1),
            max(1, ch * depth // 8))


def _exif_orientation(exif: bytes) -> int:
    """The Orientation tag (0x0112) of an eXIf chunk's TIFF directory, 1
    (as stored) when it is missing or unreadable."""
    order = {b"II": "<", b"MM": ">"}.get(exif[:2])
    try:
        (ifd,) = struct.unpack(order + "I", exif[4:8])
        (n,) = struct.unpack(order + "H", exif[ifd:ifd + 2])
        for i in range(n):
            at = ifd + 2 + 12 * i
            tag, kind, count = struct.unpack(order + "HHI", exif[at:at + 8])
            if tag == 0x0112 and kind == 3 and count == 1:
                (value,) = struct.unpack(order + "H", exif[at + 8:at + 10])
                return value if 1 <= value <= 8 else 1
    except (TypeError, struct.error):
        pass
    return 1


def _orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """OpenCV's ExifTransform: orientations 5-8 transpose first; 2, 6 flip
    left-right, 4, 8 top-bottom, 3, 7 both."""
    if orientation >= 5:
        img = img.swapaxes(0, 1)
    if orientation in (2, 3, 6, 7):
        img = img[:, ::-1]
    if orientation in (3, 4, 7, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode_png(data: bytes, mode: str = "color", path="<bytes>",
               native: bool = True) -> np.ndarray:
    """The PNG file `data` as `imread` returns it; `native=False`
    unfilters with the numpy twin."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {MODES}")
    (w, h, depth, color, lace), extra, stream = _inflate(data, path)
    ch = _CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    unfilter = unfilter_native if native else unfilter_numpy
    passes = ADAM7 if lace else ((0, 0, 1, 1),)
    out = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        rowbytes = (pw * ch * depth + 7) // 8
        size = _pass_size(rowbytes, ph, pos, stream, path)
        scan = np.frombuffer(stream, np.uint8, size, pos).reshape(ph, -1)
        try:
            rows = unfilter(scan, bpp)
        except ValueError as e:
            raise PNGError(path, str(e)) from None
        out[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
        pos += size
    img = _convert(out, color, depth, mode, extra.get(b"PLTE"),
                   extra.get(b"tRNS"))
    if mode == "color" and b"eXIf" in extra:
        img = _orient(img, _exif_orientation(extra[b"eXIf"]))
    return img


def _to8(s: np.ndarray, depth: int) -> np.ndarray:
    if depth == 16:
        return (s >> 8).astype(np.uint8)
    if depth < 8:
        return (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return s


def _convert(s, color, depth, mode, palette, trns):
    """(h, w, ch) samples -> what OpenCV's decoder gives in `mode`."""
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(palette)] = palette
        bgr = pal[s[..., 0]][..., ::-1]
        if mode == "unchanged" and trns is not None:
            alpha = np.full(256, 255, np.uint8)
            alpha[:min(len(trns), 256)] = np.frombuffer(trns[:256], np.uint8)
            return np.ascontiguousarray(
                np.concatenate([bgr, alpha[s[..., :1]]], axis=2))
        return np.ascontiguousarray(bgr)
    if mode == "color":
        s = _to8(s, depth)
        gray = color in (0, 4)
        bgr = np.repeat(s[..., :1], 3, axis=2) if gray else s[..., 2::-1]
        return np.ascontiguousarray(bgr)
    if depth < 8:
        s = _to8(s, depth)
    if color == 0:
        return np.ascontiguousarray(s[..., 0])
    if color == 4:
        return np.ascontiguousarray(
            np.concatenate([np.repeat(s[..., :1], 3, axis=2), s[..., 1:]],
                           axis=2))
    bgr = s[..., 2::-1]
    if color == 6:
        return np.ascontiguousarray(np.concatenate([bgr, s[..., 3:]], axis=2))
    if trns is not None and len(trns) == 6:
        key = np.asarray(struct.unpack(">HHH", trns), s.dtype)
        top = np.iinfo(s.dtype).max
        alpha = np.where((s == key).all(-1, keepdims=True), 0, top)
        return np.ascontiguousarray(
            np.concatenate([bgr, alpha.astype(s.dtype)], axis=2))
    return np.ascontiguousarray(bgr)


def imread(path, mode: str = "color", native: bool = True) -> np.ndarray:
    """cv2.imread(path, IMREAD_COLOR / IMREAD_UNCHANGED) of a PNG file."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(f"{path}: no such image file") from None
    return decode_png(data, mode, path, native)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 4,
               level: int = 1) -> bytes:
    """uint8 (H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA -> PNG bytes."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in (1, 3, 4) or 0 in img.shape:
        raise ValueError(f"imwrite takes (H, W), (H, W, 3) or (H, W, 4), "
                         f"not {img.shape}")
    h, w, ch = img.shape
    color = {1: 0, 3: 2, 4: 6}[ch]
    if ch >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    scan = filter_rows(img.reshape(h, w * ch), ch, filters)
    head = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", head)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), level))
            + _chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, filters: Union[int, Sequence[int]] = 4,
            level: int = 1) -> None:
    """Write `img` as a PNG file (see `encode_png`); the directory must
    exist, as for cv2.imwrite."""
    data = encode_png(img, filters, level)
    with open(path, "wb") as f:
        f.write(data)
