"""The port's JPEG codec (``data/jpeg.py``) against PIL's libjpeg-turbo,
bit for bit: the decoder on seeded smooth, noisy and gray images at
sizes that are not multiples of 8 or 16, qualities 50 / 75 / 95,
subsampling 4:4:4 / 4:2:2 / 4:2:0 and restart intervals; its refusals;
and the encoder, whose files PIL decodes to the array it decodes its own
file of the same pixels to. No tolerance anywhere."""

import io

import numpy as np
import pytest
from PIL import Image

from imageretrievalresearch_tpu_torch.data import decode_image
from imageretrievalresearch_tpu_torch.data import jpeg as J
from imageretrievalresearch_tpu_torch.data.decode import MAX_PIXELS

SIZES = [(1, 1), (2, 3), (8, 8), (17, 33), (33, 17), (64, 48), (9, 1)]
QUALITIES = [50, 75, 95]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


def smooth(rng, h, w, channels=3):
    """A bilinear upsampling of a coarse random field, + a little noise."""
    low = rng.integers(0, 256, (max(2, h // 6), max(2, w // 6), channels),
                       dtype=np.uint8)
    im = Image.fromarray(low if channels == 3 else low[..., 0])
    arr = np.asarray(im.resize((w, h), Image.BILINEAR)).astype(np.int16)
    arr = arr + rng.integers(-6, 7, arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def image(kind, rng, h, w):
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "gray":
        return smooth(rng, h, w, 1)
    return smooth(rng, h, w)


def pil_jpeg(arr, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("kind", ["smooth", "noise", "gray"])
@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
def test_decode_equals_pil(kind, quality, sub):
    rng = np.random.default_rng([quality, SUBSAMPLING[sub],
                                 ["smooth", "noise", "gray"].index(kind)])
    for h, w in SIZES:
        data = pil_jpeg(image(kind, rng, h, w), quality=quality,
                        subsampling=SUBSAMPLING[sub])
        got = J.decode_jpeg(data, MAX_PIXELS)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, pil_rgb(data), err_msg=str((h, w)))


@pytest.mark.parametrize("restart", [{"restart_marker_blocks": 1},
                                     {"restart_marker_blocks": 5},
                                     {"restart_marker_rows": 1}])
@pytest.mark.parametrize("sub", [0, 2])
def test_decode_restart_intervals(restart, sub):
    """PIL writes DRI and RSTn markers; DC predictions reset per
    interval."""
    rng = np.random.default_rng(sub)
    arr = rng.integers(0, 256, (37, 51, 3), dtype=np.uint8)
    data = pil_jpeg(arr, subsampling=sub, **restart)
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(J.decode_jpeg(data, MAX_PIXELS),
                                  pil_rgb(data))


def test_decode_photo_size_and_dispatch(tmp_path):
    """A 256 px structured photo, as the synthetic Sketchy tree holds,
    through ``decode_image`` from a path and from bytes."""
    rng = np.random.default_rng(11)
    arr = np.clip(smooth(rng, 256, 256).astype(float)
                  + rng.normal(0, 28, (256, 256, 3)), 0, 255).astype(np.uint8)
    data = pil_jpeg(arr)
    path = tmp_path / "p.jpg"
    path.write_bytes(data)
    ref = pil_rgb(data)
    np.testing.assert_array_equal(decode_image(path), ref)
    np.testing.assert_array_equal(decode_image(data), ref)


def test_decode_rgb_colour_space_and_markers():
    """Component ids R, G, B without JFIF mean RGB samples (no colour
    conversion), as libjpeg guesses; APPn and COM segments are skipped."""
    rng = np.random.default_rng(3)
    arr = smooth(rng, 16, 24)
    data = pil_jpeg(arr, subsampling=0, comment=b"hello")
    np.testing.assert_array_equal(J.decode_jpeg(data, MAX_PIXELS),
                                  pil_rgb(data))
    # strip APP0 (JFIF) and rename the components R, G, B: the decoder
    # must take the planes as RGB, as PIL does
    assert data[2:4] == b"\xff\xe0"
    n = int.from_bytes(data[4:6], "big")
    bare = bytearray(data[:2] + data[4 + n:])
    sof = bare.index(b"\xff\xc0")
    for i, cid in enumerate(b"RGB"):
        bare[sof + 10 + 3 * i] = cid
    sos = bare.index(b"\xff\xda")
    for i, cid in enumerate(b"RGB"):
        bare[sos + 5 + 2 * i] = cid
    np.testing.assert_array_equal(J.decode_jpeg(bytes(bare), MAX_PIXELS),
                                  pil_rgb(bytes(bare)))


def test_decode_refusals():
    rng = np.random.default_rng(5)
    arr = smooth(rng, 24, 24)
    with pytest.raises(ValueError, match="progressive"):
        decode_image(pil_jpeg(arr, progressive=True))
    cmyk = io.BytesIO()
    Image.fromarray(arr).convert("CMYK").save(cmyk, format="JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        decode_image(cmyk.getvalue())
    good = pil_jpeg(arr)
    for cut in (3, 40, len(good) // 2, len(good) - 2):
        with pytest.raises(ValueError, match="truncated"):
            decode_image(good[:cut])
    twelve = bytearray(good)
    sof = twelve.index(b"\xff\xc0")
    twelve[sof + 4] = 12
    with pytest.raises(ValueError, match="12-bit"):
        decode_image(bytes(twelve))
    big = bytearray(good)
    big[sof + 5:sof + 9] = (40000).to_bytes(2, "big") * 2
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_image(bytes(big))
    arith = bytearray(good)
    arith[sof + 1] = 0xC9
    with pytest.raises(ValueError, match="arithmetic"):
        decode_image(bytes(arith))
    np.testing.assert_array_equal(decode_image(good), pil_rgb(good))


@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_encode_decodes_like_pils_file(kind):
    """PIL decodes the port's file of an array to what it decodes its own
    ``save(.., "JPEG")`` of that array to (the same coefficients), and
    the port's decoder reads the port's file the same way."""
    rng = np.random.default_rng(["smooth", "noise"].index(kind))
    for h, w in SIZES + [(256, 256), (100, 7), (16, 16)]:
        arr = image(kind, rng, h, w)
        mine = J.encode_jpeg(arr)
        ref = pil_rgb(pil_jpeg(arr))
        np.testing.assert_array_equal(pil_rgb(mine), ref, err_msg=str((h, w)))
        np.testing.assert_array_equal(J.decode_jpeg(mine, MAX_PIXELS), ref)


def test_encode_tables_and_refusals():
    """Quality 75's tables are PIL's (``quantization``, natural order);
    the encoder takes (H, W, 3) uint8 only."""
    with Image.open(io.BytesIO(pil_jpeg(np.zeros((8, 8, 3), np.uint8)))) as im:
        pil_tables = im.quantization
    for tid, table in enumerate(J.quality_tables(75)):
        np.testing.assert_array_equal(table.ravel(), pil_tables[tid])
    with pytest.raises(ValueError, match="uint8"):
        J.encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        J.encode_jpeg(np.zeros((4, 4, 3), np.float32))


def test_idct_and_fdct_against_float_dct():
    """The integer transforms track the exact float DCT pair within the
    islow rounding (one level on samples, one unit on coefficients)."""
    rng = np.random.default_rng(2)
    blocks = rng.integers(0, 256, (50, 8, 8)).astype(np.uint8)
    k = np.arange(8)
    c = np.where(k == 0, np.sqrt(1 / 8), np.sqrt(2 / 8))[:, None] * np.cos(
        (2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    exact = c @ (blocks.astype(float) - 128) @ c.T
    coef = J.fdct_islow(blocks)
    assert np.abs(coef / 8 - exact).max() <= 1.0
    ones = np.ones((8, 8), np.int64)
    back = J.idct_islow(np.round(exact).astype(np.int64), ones)
    ref = np.clip(np.round(c.T @ np.round(exact) @ c) + 128, 0, 255)
    assert np.abs(back.astype(int) - ref).max() <= 1
