"""Data layer: dataset indexing, split policies, host-side loading, and
image decoding without PIL.

Counterpart of ``imageretrievalresearch_tpu/data``: pure-Python indexing
(globbing directory layouts, building pos/neg candidate lists) feeding the
device-side preprocessing, and the port's own PNG and JPEG codecs
(``data.decode``, ``data.jpeg``). The reference's dataset families:

- Sketchy DB-256 layout (reference data/sketch_dataset.py)
- "original"/spec layout (reference data/original_dataset.py)
- soft real/+sketch/ layout (reference data/softdataset.py)
- simple class-folder photo/sketch layout (reference data/triplet_dataset.py)
- ImageFolder classification tree (reference train/train_vit_crossentropy.py:50)

``data.native_loader`` stands for the JAX package's C++ batch decoder:
the same contract, on a pool of decode processes over the port's codecs.
"""

from imageretrievalresearch_tpu_torch.data.decode import (
    decode_image,
    encode_png,
    resize_bilinear_host,
    square_pad_host,
)
from imageretrievalresearch_tpu_torch.data.imagefolder import (
    ImageFolderDataset,
)
from imageretrievalresearch_tpu_torch.data.index import TripletIndex
from imageretrievalresearch_tpu_torch.data.jpeg import (
    decode_jpeg,
    encode_jpeg,
)
from imageretrievalresearch_tpu_torch.data.loader import TripletLoader
from imageretrievalresearch_tpu_torch.data.original import (
    OriginalDataset,
    OriginalImageDataset,
)
from imageretrievalresearch_tpu_torch.data.sketchy import (
    SketchyDataset,
    SketchyImageDataset,
)
from imageretrievalresearch_tpu_torch.data.soft import (
    TripletDataset,
    TripletImageDataset,
)
from imageretrievalresearch_tpu_torch.data.splits import (
    IMG_EXTS,
    data_split_original,
    data_split_sketchy,
    data_split_soft,
)
from imageretrievalresearch_tpu_torch.data.triple import TripleDataset

__all__ = [
    "IMG_EXTS",
    "decode_image",
    "decode_jpeg",
    "encode_jpeg",
    "encode_png",
    "resize_bilinear_host",
    "square_pad_host",
    "data_split_sketchy",
    "data_split_original",
    "data_split_soft",
    "TripletIndex",
    "SketchyDataset",
    "SketchyImageDataset",
    "OriginalDataset",
    "OriginalImageDataset",
    "TripletDataset",
    "TripletImageDataset",
    "TripleDataset",
    "ImageFolderDataset",
    "TripletLoader",
]
