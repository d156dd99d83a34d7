"""Data layer: image decoding without PIL (``data.decode``) and the image
suffixes of class-per-subfolder trees (``data.splits``). The datasets and
loaders are not ported yet."""

from imageretrievalresearch_tpu_torch.data.decode import (
    decode_image,
    resize_bilinear_host,
    square_pad_host,
)
from imageretrievalresearch_tpu_torch.data.splits import IMG_EXTS

__all__ = ["IMG_EXTS", "decode_image", "resize_bilinear_host",
           "square_pad_host"]
