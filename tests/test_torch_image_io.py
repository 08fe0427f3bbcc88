"""The port's PNG codec (data/image_io.py) and resizes (data/resize.py)
against OpenCV, which the JAX package reads and resizes with, on the CPU.

- `imread` equals `cv2.imread` in "color" (IMREAD_COLOR) and "unchanged"
  (IMREAD_UNCHANGED), array, shape and dtype, on files written by
  `cv2.imwrite` (8- and 16-bit gray and colour, BGRA, 1-bit bilevel), by
  PIL (palettes of 1-8 bits with and without tRNS, gray + alpha, 1-bit,
  16-bit gray, RGB with a tRNS key, RGBA) and by this file's own encoder
  (every colour type and bit depth, tRNS, Adam7, each row filter), over
  hypothesis-drawn shapes; with the host core and the numpy twin.
- The host core's unfilter equals its numpy twin on random scanlines.
- `imwrite` round-trips through `cv2.imread`, every filter type; a bad CRC,
  a truncated file, a JPEG, an unknown critical chunk, an unknown filter
  type and a missing file raise, naming the path.
- Resizes: bilinear on float32 over 1-6 channels (up, down, exactly 2x
  down, one-pixel sides), on uint8 (the visualisation's path), nearest on
  uint8 and int32, all equal to `cv2.resize` bit for bit, the float32 ones
  in the host core and in its numpy twin; `fma32` rounds once.
"""
import struct
import zlib
from fractions import Fraction

import cv2
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

from multimodal_sam_adapter_torch.data import image_io, resize

# deterministic draws; a file name carries each example's seed, so the
# function-scoped tmp_path is safe to share between examples
SETTINGS = settings(max_examples=6, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])
SIDES = st.integers(1, 40)


def _same(got, want):
    assert want is not None
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_array_equal(got, want)


def _check(path):
    """imread == cv2.imread in both modes, core and twin."""
    for mode, flag in (("color", cv2.IMREAD_COLOR),
                       ("unchanged", cv2.IMREAD_UNCHANGED)):
        want = cv2.imread(str(path), flag)
        for native in (True, False):
            _same(image_io.imread(path, mode, native=native), want)


# ---------------------------------------------------------------------------
# an independent encoder: any colour type, bit depth, tRNS, Adam7, filters
# ---------------------------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(t, d):
    return (struct.pack(">I", len(d)) + t + d
            + struct.pack(">I", zlib.crc32(t + d)))


def _pack(samples, depth):
    """(h, n) sample values -> (h, rowbytes) bytes, big-endian, MSB first."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(len(samples), -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    s = np.pad(samples, ((0, 0), (0, (-samples.shape[1]) % per)))
    s = s.reshape(len(s), -1, per).astype(np.int64)
    return (s << (np.arange(per - 1, -1, -1) * depth)).sum(-1).astype(
        np.uint8)


def _filtered(raw, bpp, ftypes):
    """Scanlines, row y filtered with ftypes[y % len(ftypes)], written out
    byte by byte from the PNG specification."""
    out = bytearray()
    h, n = raw.shape
    for y in range(h):
        f = ftypes[y % len(ftypes)]
        out.append(f)
        for i in range(n):
            a = int(raw[y, i - bpp]) if i >= bpp else 0
            b = int(raw[y - 1, i]) if y else 0
            c = int(raw[y - 1, i - bpp]) if y and i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[f]
            out.append((int(raw[y, i]) - pred) & 255)
    return bytes(out)


def encode(samples, color, depth, palette=None, trns=None, interlace=0,
           ftypes=(0,)):
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    passes = image_io.ADAM7 if interlace else ((0, 0, 1, 1),)
    data = b""
    for x0, y0, dx, dy in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            data += _filtered(_pack(sub.reshape(len(sub), -1), depth), bpp,
                              ftypes)
    out = image_io.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).ravel()))
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(data)
    # two IDAT chunks: the reader must join them
    out += _chunk(b"IDAT", z[:len(z) // 2]) + _chunk(b"IDAT", z[len(z) // 2:])
    return out + _chunk(b"IEND", b"")


KINDS = [(color, depth, lace, trns)
         for color, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)),
                               (3, (1, 2, 4, 8)), (4, (8, 16)), (6, (8, 16)))
         for depth in depths for lace in (0, 1)
         for trns in ((False, True) if color in (0, 2, 3) else (False,))]


@pytest.mark.parametrize("color,depth,lace,trns", KINDS)
@SETTINGS
@given(h=SIDES, w=SIDES, seed=st.integers(0, 2 ** 16))
def test_imread_equals_opencv_on_every_png_kind(tmp_path, color, depth,
                                                lace, trns, h, w, seed):
    rng = np.random.default_rng(seed)
    top = 1 << depth
    palette = key = None
    if color == 3:
        n = int(rng.integers(1, min(top, 256) + 1))
        palette = rng.integers(0, 256, (n, 3))
        # some indices past the palette's end when it is short
        samples = rng.integers(0, top, (h, w, 1))
        if trns:
            key = bytes(rng.integers(0, 256, int(rng.integers(1, n + 1)))
                        .astype(np.uint8))
    else:
        samples = rng.integers(0, top, (h, w, CHANNELS[color]))
        if trns:
            key = struct.pack(">" + "H" * CHANNELS[color],
                              *map(int, samples[0, 0]))
    ftypes = tuple(int(f) for f in rng.permutation(5))
    path = tmp_path / f"k{seed}.png"
    path.write_bytes(encode(samples, color, depth, palette, key, lace,
                            ftypes))
    _check(path)


@SETTINGS
@given(h=SIDES, w=SIDES, seed=st.integers(0, 2 ** 16))
def test_imread_equals_opencv_on_files_opencv_writes(tmp_path, h, w, seed):
    rng = np.random.default_rng(seed)
    for i, (shape, dtype) in enumerate((
            ((h, w), np.uint8), ((h, w, 3), np.uint8),
            ((h, w, 4), np.uint8), ((h, w), np.uint16),
            ((h, w, 3), np.uint16), ((h, w, 4), np.uint16))):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        for j, params in enumerate(([], [cv2.IMWRITE_PNG_COMPRESSION, 9])):
            path = tmp_path / f"cv{seed}_{i}_{j}.png"
            assert cv2.imwrite(str(path), img, params)
            _check(path)
    path = tmp_path / f"bilevel{seed}.png"
    assert cv2.imwrite(str(path), (rng.random((h, w)) < 0.5).astype(
        np.uint8) * 255, [cv2.IMWRITE_PNG_BILEVEL, 1])
    _check(path)


@SETTINGS
@given(h=SIDES, w=SIDES, seed=st.integers(0, 2 ** 16))
def test_imread_equals_opencv_on_files_pil_writes(tmp_path, h, w, seed):
    rng = np.random.default_rng(seed)
    u8 = lambda *s: rng.integers(0, 256, (h, w) + s).astype(np.uint8)  # noqa
    files = []
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(rng.integers(0, 1 << bits, (h, w))
                             .astype(np.uint8), "P")
        im.putpalette(list(rng.integers(0, 256, 3 << bits)))
        files.append((im, dict(bits=bits)))
        files.append((im, dict(bits=bits, transparency=bytes(
            rng.integers(0, 256, 1 << bits).astype(np.uint8)))))
    files += [
        (Image.fromarray(np.dstack([u8(), u8()]), "LA"), {}),
        (Image.fromarray(u8() >= 128), {}),                       # 1-bit
        (Image.fromarray(rng.integers(0, 65536, (h, w)).astype(np.uint16)),
         {}),                                                      # I;16
        (Image.fromarray(u8(3), "RGB"), dict(transparency=(1, 2, 3))),
        (Image.fromarray(u8(4), "RGBA"), {}),
        (Image.fromarray(u8(), "L"), dict(optimize=True)),
    ]
    for i, (im, kw) in enumerate(files):
        path = tmp_path / f"pil{seed}_{i}.png"
        im.save(path, **kw)
        _check(path)


# ---------------------------------------------------------------------------
# unfilter: core vs twin
# ---------------------------------------------------------------------------

@SETTINGS
@given(h=st.integers(1, 30), n=st.integers(1, 120), bpp=st.integers(1, 8),
       seed=st.integers(0, 2 ** 16))
def test_unfilter_core_equals_its_numpy_twin(h, n, bpp, seed):
    rng = np.random.default_rng(seed)
    scan = rng.integers(0, 256, (h, n + 1)).astype(np.uint8)
    scan[:, 0] = rng.integers(0, 5, h)
    _same(image_io.unfilter_native(scan, bpp),
          image_io.unfilter_numpy(scan, bpp))


def test_unfilter_inverts_filter_rows():
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (23, 51)).astype(np.uint8)
    for bpp in (1, 3, 4, 6):
        scan = image_io.filter_rows(raw, bpp, (0, 1, 2, 3, 4))
        _same(image_io.unfilter_native(scan, bpp), raw)
        _same(image_io.unfilter_numpy(scan, bpp), raw)


# ---------------------------------------------------------------------------
# imwrite and the errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, (0, 1, 2, 3, 4)])
@SETTINGS
@given(h=SIDES, w=SIDES, ch=st.sampled_from([0, 3, 4]),
       seed=st.integers(0, 2 ** 16))
def test_imwrite_round_trips_through_opencv(tmp_path, filters, h, w, ch,
                                            seed):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, ch) if ch else (h, w)).astype(np.uint8)
    path = tmp_path / f"w{seed}.png"
    image_io.imwrite(path, img, filters=filters)
    _same(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    _same(image_io.imread(path, "unchanged"), img)


@pytest.fixture
def good_png(tmp_path):
    path = tmp_path / "good.png"
    image_io.imwrite(path, np.arange(60, dtype=np.uint8).reshape(5, 4, 3))
    return path


def _raises(path, match):
    with pytest.raises(image_io.PNGError, match=match) as e:
        image_io.imread(path)
    assert str(path) in str(e.value)


def test_a_corrupt_crc_raises_naming_the_path(good_png):
    data = bytearray(good_png.read_bytes())
    data[40] ^= 0xFF          # a byte of the IDAT chunk's body
    good_png.write_bytes(bytes(data))
    _raises(good_png, "bad CRC")


@pytest.mark.parametrize("keep", [0.3, 0.8, 0.97])
def test_a_truncated_file_raises_naming_the_path(good_png, keep):
    data = good_png.read_bytes()
    good_png.write_bytes(data[:int(len(data) * keep)])
    _raises(good_png, "truncated")


def test_a_truncated_stream_raises_naming_the_path(tmp_path):
    z = zlib.compress(bytes(5 * 13))[:-6]
    path = tmp_path / "short.png"
    path.write_bytes(image_io.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 4, 5, 8, 2, 0, 0, 0)) + _chunk(b"IDAT", z)
        + _chunk(b"IEND", b""))
    _raises(path, "truncated image data")


def test_a_jpeg_raises_naming_the_path(tmp_path):
    path = tmp_path / "photo.png"
    ok, buf = cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8))
    path.write_bytes(buf.tobytes())
    _raises(path, "not a PNG file \\(a JPEG\\)")


def test_an_unknown_critical_chunk_or_filter_raises(good_png, tmp_path):
    data = good_png.read_bytes()
    at = data.index(b"IDAT") - 4
    path = tmp_path / "crit.png"
    path.write_bytes(data[:at] + _chunk(b"ABCD", b"x") + data[at:])
    _raises(path, "unknown critical chunk")
    path.write_bytes(data[:at] + _chunk(b"abCD", b"x") + data[at:])
    assert image_io.imread(path).shape == (5, 4, 3)     # ancillary: skipped
    scan = np.zeros((2, 4), np.uint8)
    scan[1, 0] = 7
    path = tmp_path / "filter.png"
    path.write_bytes(image_io.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", 3, 2, 8, 0, 0, 0, 0)) + _chunk(
        b"IDAT", zlib.compress(scan.tobytes())) + _chunk(b"IEND", b""))
    for native in (True, False):
        with pytest.raises(image_io.PNGError, match="unknown filter type 7"):
            image_io.imread(path, native=native)


def test_a_missing_file_raises_naming_the_path(tmp_path):
    path = tmp_path / "nowhere.png"
    with pytest.raises(FileNotFoundError, match="nowhere.png"):
        image_io.imread(path)


# ---------------------------------------------------------------------------
# resizes
# ---------------------------------------------------------------------------

def _cv_resize(img, wh, flag):
    return cv2.resize(img, wh, interpolation=flag)


@pytest.mark.parametrize("cn", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("kind", ["up", "down", "2x", "thin"])
@SETTINGS
@given(seed=st.integers(0, 2 ** 16))
def test_bilinear_float32_equals_opencv(cn, kind, seed):
    rng = np.random.default_rng(seed)
    sh, sw = (int(v) for v in rng.integers(2, 48, 2))
    if kind == "up":
        dh, dw = sh + int(rng.integers(1, 90)), sw + int(rng.integers(1, 90))
    elif kind == "down":
        dh, dw = (int(v) for v in rng.integers(1, [sh + 1, sw + 1]))
    elif kind == "2x":
        dh, dw = sh, sw
        sh, sw = 2 * sh, 2 * sw
    else:                       # one-pixel source sides
        sh, sw = (1, sw) if seed % 2 else (sh, 1)
        dh, dw = (int(v) for v in rng.integers(1, 60, 2))
    img = (rng.standard_normal((sh, sw, cn)) * 70 + 120).astype(np.float32)
    src = img[..., 0] if cn == 1 and seed % 2 else img
    want = _cv_resize(src, (dw, dh), cv2.INTER_LINEAR)
    for native in (True, False):
        got = resize.resize(src, (dw, dh), "bilinear", native=native)
        _same(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("cn", [1, 2, 3, 4])
@SETTINGS
@given(sh=SIDES, sw=SIDES, dh=st.integers(1, 90), dw=st.integers(1, 90),
       seed=st.integers(0, 2 ** 16))
def test_bilinear_uint8_equals_opencv(cn, sh, sw, dh, dw, seed):
    img = np.random.default_rng(seed).integers(0, 256, (sh, sw, cn)).astype(
        np.uint8)
    _same(resize.resize(img, (dw, dh)),
          _cv_resize(img, (dw, dh), cv2.INTER_LINEAR))
    half = np.repeat(np.repeat(img, 2, 0), 2, 1)     # an exact 2x down
    half[::2, ::2] ^= 1
    _same(resize.resize(half, (sw, sh)),
          _cv_resize(half, (sw, sh), cv2.INTER_LINEAR))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@SETTINGS
@given(sh=SIDES, sw=SIDES, dh=st.integers(1, 90), dw=st.integers(1, 90),
       seed=st.integers(0, 2 ** 16))
def test_nearest_equals_opencv(dtype, sh, sw, dh, dw, seed):
    lab = np.random.default_rng(seed).integers(0, 200, (sh, sw)).astype(
        dtype)
    _same(resize.resize(lab, (dw, dh), "nearest"),
          _cv_resize(lab, (dw, dh), cv2.INTER_NEAREST))


def test_resize_channels_chunks_by_four_at_muses_size():
    """A 6-channel MUSES frame (1080x1920 -> 1024x1820): OpenCV on channels
    0-3 and 4-5, the core, and the twin on a band of rows."""
    rng = np.random.default_rng(0)
    img = (rng.random((1080, 1920, 6)) * 255).astype(np.float32)
    want = np.concatenate([_cv_resize(img[..., :4], (1820, 1024),
                                      cv2.INTER_LINEAR),
                           _cv_resize(img[..., 4:], (1820, 1024),
                                      cv2.INTER_LINEAR)], axis=2)
    _same(resize.resize_channels(img, (1820, 1024)), want)
    band = img[:64]
    want = np.concatenate([_cv_resize(band[..., :4], (1820, 61),
                                      cv2.INTER_LINEAR),
                           _cv_resize(band[..., 4:], (1820, 61),
                                      cv2.INTER_LINEAR)], axis=2)
    _same(resize.resize_channels(band, (1820, 61), native=False), want)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic, on random operands and on
    ones whose float64 sum lands on a float32 tie."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(2000) * 10).astype(np.float32)
    b = (rng.standard_normal(2000) * 10).astype(np.float32)
    c = (rng.standard_normal(2000) * 1e4).astype(np.float32)
    # c = +-(1 + 2^-23) (an odd float32) and a * b = +-(2^-24 - 2^-70),
    # 2^-70 short of half c's ulp: the float64 sum rounds onto the float32
    # tie, which rounding it again would break up to the even neighbour
    odd = np.float32(1 + 2 ** -23)
    a = np.append(a, [odd, -odd])
    b = np.append(b, [np.float32(2 ** -24 * (1 - 2 ** -23))] * 2)
    c = np.append(c, [odd, -odd])
    got = resize.fma32(a, b, c)
    for x, y, z, g in zip(a, b, c, got):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert g == best, (x, y, z, g, best)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("orientation", range(0, 10))
def test_exif_orientation_turns_color_as_opencv_does(tmp_path, order,
                                                     orientation):
    """An eXIf chunk's Orientation (1-8; 0 and 9 are invalid): "color"
    turns the image as IMREAD_COLOR does, "unchanged" does not."""
    img = np.arange(4 * 7 * 3, dtype=np.uint8).reshape(4, 7, 3) * 2
    tiff = ((b"II" if order == "<" else b"MM")
            + struct.pack(order + "HIH", 42, 8, 2)
            + struct.pack(order + "HHI", 0x010F, 2, 4) + b"cam\x00"
            + struct.pack(order + "HHIH", 0x0112, 3, 1, orientation)
            + b"\x00\x00" + struct.pack(order + "I", 0))
    data = image_io.encode_png(img)
    at = data.index(b"IDAT") - 4
    path = tmp_path / f"exif{orientation}.png"
    path.write_bytes(data[:at] + _chunk(b"eXIf", tiff) + data[at:])
    _check(path)
