"""Dataset split helpers.

Counterpart of ``imageretrievalresearch_tpu/data/splits.py``. Only the
image suffixes are ported so far: the rest of the module comes with the
data layer.
"""

#: image suffixes recognized when walking class-per-subfolder trees
#: (the gallery-build CLI)
IMG_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".webp"}
