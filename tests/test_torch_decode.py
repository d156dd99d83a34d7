"""The port's image decoding without PIL (``data/decode.py``) held against
PIL, which the JAX package decodes with: PNG files in every colour type
and bit depth PIL writes, and files of this test's own writer with one
filter type each, decode bit for bit as ``Image.open(..).convert("RGB")``;
the refused inputs raise ``ValueError``; the host resize equals Pillow's
bilinear ``Image.resize`` and the square pad the JAX CLI's
``_square_pad_pil``."""

import functools
import io
import struct
import tracemalloc
import zlib

import numpy as np
import pytest
from PIL import Image

from imageretrievalresearch_tpu.cli.gallery import _square_pad_pil
from imageretrievalresearch_tpu_torch.data.decode import (
    decode_image,
    resize_bilinear_host,
    square_pad_host,
)


def smooth(rng, h, w, c=3):
    """A seeded image with gradients and noise (every filter gets used)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     (x + y) * 3 % 256, x * y % 256], -1)[..., :c]
    return ((base + rng.integers(0, 48, (h, w, c))) % 256).astype(np.uint8)


def pil_bytes(im, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_png(samples, color_type, depth=8, ftype=0, palette=None,
              interlace=0) -> bytes:
    """A minimal PNG writer: (H, W, channels) samples, every row filtered
    with ``ftype``; below 8 bits the rows are packed MSB first."""
    h, w = samples.shape[:2]
    if depth < 8:
        per = 8 // depth
        s = samples.reshape(h, w).astype(np.uint16)
        s = np.pad(s, ((0, 0), (0, -w % per)))
        shifts = np.arange(8 - depth, -1, -depth)
        rows = (s.reshape(h, -1, per) << shifts).sum(axis=2)
    else:
        rows = samples.reshape(h, -1)
    bpp = max(1, samples.shape[2] * depth // 8)
    x = rows.astype(np.int16)
    up = np.vstack([np.zeros_like(x[:1]), x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][ftype]
    filt = ((x - pred) & 255).astype(np.uint8)
    raw = np.hstack([np.full((h, 1), ftype, np.uint8), filt]).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, color_type, 0, 0, interlace))
    if palette is not None:
        out += png_chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return (out + png_chunk(b"IDAT", zlib.compress(raw))
            + png_chunk(b"IEND", b""))


def adam7_png(img: np.ndarray) -> bytes:
    """An Adam7-interlaced RGB PNG of ``img`` (filter None on every row of
    every pass); Pillow reads such files but does not write them."""
    h, w = img.shape[:2]
    raw = bytearray()
    for y0, x0, ys, xs in ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4),
                           (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
                           (1, 0, 2, 1)):
        sub = img[y0::ys, x0::xs]
        if sub.size:
            for row in sub:
                raw += b"\0" + row.tobytes()
    return (b"\x89PNG\r\n\x1a\n"
            + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                             1))
            + png_chunk(b"IDAT", zlib.compress(bytes(raw)))
            + png_chunk(b"IEND", b""))


def png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


@functools.cache
def bomb_pngs() -> dict[str, bytes]:
    """Two decompression bombs, both small files: an 8 x 8 RGB image whose
    image data inflates to 64 MiB of zeros (64 KB compressed), and a
    header that claims 20,000 x 20,000 pixels, past PIL's limit."""
    def png(w, h, idat):
        return (b"\x89PNG\r\n\x1a\n"
                + png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                 0, 0))
                + png_chunk(b"IDAT", idat) + png_chunk(b"IEND", b""))

    deflate, zeros = zlib.compressobj(9), bytes(1 << 20)
    flood = b"".join(deflate.compress(zeros) for _ in range(64))
    return {"inflates_past_ihdr": png(8, 8, flood + deflate.flush()),
            "too_many_pixels": png(20000, 20000, zlib.compress(bytes(64)))}


def _pil_cases():
    rng = np.random.default_rng(11)
    quant = Image.fromarray(smooth(rng, 40, 41)).quantize(200)
    gray = smooth(rng, 31, 29, 1)[..., 0]
    return {
        "L": pil_bytes(Image.fromarray(gray, "L")),
        "LA": pil_bytes(Image.fromarray(smooth(rng, 31, 29, 2), "LA")),
        "RGB": pil_bytes(Image.fromarray(smooth(rng, 37, 53))),
        "RGBA": pil_bytes(Image.fromarray(smooth(rng, 37, 53, 4), "RGBA")),
        "P": pil_bytes(quant),
        "P_transparency": pil_bytes(quant, transparency=3),
        "P_16_bits4": pil_bytes(Image.fromarray(
            smooth(rng, 33, 45)).quantize(16), bits=4),
        "1": pil_bytes(Image.fromarray(gray > 127).convert("1")),
    }


PIL_CASES = _pil_cases()


@pytest.mark.parametrize("mode", sorted(PIL_CASES))
def test_decode_equals_pil_on_pil_files(mode):
    data = PIL_CASES[mode]
    im = Image.open(io.BytesIO(data))
    assert im.mode == mode.split("_")[0]
    if mode == "P_transparency":
        assert "transparency" in im.info
    ref = pil_rgb(data)
    out = decode_image(data)
    assert out.dtype == np.uint8 and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


# (colour type, bit depth, channels): the writer's own files, one filter
# type each, on a 13 x 19 image (rows of odd lengths, bytes not filled);
# the palettes are shorter than the index range (PIL reads black past it)
WRITER_CASES = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (2, 8, 3),
                (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2),
                (6, 8, 4)]


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("color_type,depth,channels", WRITER_CASES)
def test_decode_equals_pil_on_each_filter(color_type, depth, channels,
                                          ftype, tmp_path):
    rng = np.random.default_rng(100 * color_type + 10 * depth + ftype)
    h, w = 13, 19
    if depth < 8:
        samples = rng.integers(0, 1 << depth, (h, w, 1), dtype=np.uint8)
    else:
        samples = smooth(rng, h, w, channels)
    palette = (rng.integers(0, 256, (max(1, (1 << depth) - 3), 3))
               if color_type == 3 else None)
    data = write_png(samples, color_type, depth, ftype, palette)
    path = tmp_path / "x.png"
    path.write_bytes(data)
    ref = pil_rgb(data)
    np.testing.assert_array_equal(decode_image(path), ref)
    np.testing.assert_array_equal(decode_image(data), ref)
    if color_type == 0 and depth < 8:
        # the lower gray depths are scaled to 0-255 as PIL scales them
        np.testing.assert_array_equal(
            ref[..., 0], samples[..., 0].astype(int) * 255
            // ((1 << depth) - 1))


def test_decode_refusals():
    rng = np.random.default_rng(5)
    good = write_png(smooth(rng, 8, 8), 2, 8, 4)
    with pytest.raises(ValueError, match="16-bit"):
        decode_image(pil_bytes(Image.fromarray(
            rng.integers(0, 65535, (8, 8)).astype(np.uint16))))
    # Adam7 interlacing is decoded as PIL decodes it (its passes at 13 x
    # 11: every pass non-empty, the last ones ragged); an unknown
    # interlace method is refused
    inter = adam7_png(smooth(rng, 13, 11))
    np.testing.assert_array_equal(decode_image(inter), pil_rgb(inter))
    with pytest.raises(ValueError, match="bad IHDR"):
        decode_image(write_png(smooth(rng, 8, 8), 2, interlace=2))
    # a baseline JPEG decodes as PIL decodes it; a progressive one is
    # refused
    jpeg = io.BytesIO()
    Image.fromarray(smooth(rng, 8, 8)).save(jpeg, format="JPEG")
    np.testing.assert_array_equal(decode_image(jpeg.getvalue()),
                                  pil_rgb(jpeg.getvalue()))
    progressive = io.BytesIO()
    Image.fromarray(smooth(rng, 8, 8)).save(progressive, format="JPEG",
                                            progressive=True)
    with pytest.raises(ValueError, match="progressive"):
        decode_image(progressive.getvalue())
    gif = io.BytesIO()
    Image.fromarray(smooth(rng, 8, 8)).save(gif, format="GIF")
    for other in (gif.getvalue(), b"not-an-img"):
        with pytest.raises(ValueError, match="not a PNG"):
            decode_image(other)
    for cut in (20, len(good) // 2, len(good) - 5):
        with pytest.raises(ValueError, match="truncated"):
            decode_image(good[:cut])
    corrupt = bytearray(good)
    corrupt[45] ^= 0xFF                   # inside the IDAT payload
    with pytest.raises(ValueError, match="CRC"):
        decode_image(bytes(corrupt))
    np.testing.assert_array_equal(decode_image(good), pil_rgb(good))


def test_decode_refuses_decompression_bombs():
    """Data that inflates past the header's size is refused after at most
    the image's bytes were inflated (the traced peak stays far below the
    64 MiB it would inflate to), and a header past PIL's pixel limit is
    refused before anything is inflated, as PIL refuses it."""
    bombs = bomb_pngs()
    tracemalloc.start()
    try:
        with pytest.raises(ValueError, match="inflates past"):
            decode_image(bombs["inflates_past_ihdr"])
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 4 << 20
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image(bombs["too_many_pixels"])
    with pytest.raises(Image.DecompressionBombError):
        Image.open(io.BytesIO(bombs["too_many_pixels"]))


# (source h, w) -> (target h, w): down, up, non-square, identity, the
# CLI's 300 x 200 -> 256 and 256 -> 224, a strong reduction
RESIZE_CASES = [((200, 300), (256, 256)), ((256, 256), (224, 224)),
                ((64, 64), (100, 100)), ((37, 53), (20, 71)),
                ((64, 48), (64, 48)), ((300, 300), (256, 256)),
                ((500, 350), (31, 45)), ((5, 7), (64, 3))]


@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_equals_pil_bilinear(src, dst):
    img = smooth(np.random.default_rng(sum(src) + sum(dst)), *src)
    ref = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]),
                                                 Image.BILINEAR))
    out = resize_bilinear_host(img, dst)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("shape", [(200, 300), (300, 200), (31, 30),
                                   (16, 16)])
def test_square_pad_equals_jax_cli(shape):
    img = smooth(np.random.default_rng(shape[0]), *shape)
    ref = np.asarray(_square_pad_pil(Image.fromarray(img)))
    np.testing.assert_array_equal(square_pad_host(img), ref)
    # the CLI's chain: pad at source aspect, then the host resize
    np.testing.assert_array_equal(
        resize_bilinear_host(square_pad_host(img), (256, 256)),
        np.asarray(_square_pad_pil(Image.fromarray(img)).resize(
            (256, 256), Image.BILINEAR)))
