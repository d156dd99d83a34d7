"""Host-side triplet loader: threaded decode + prefetch feeding the device.

Counterpart of ``imageretrievalresearch_tpu/data/loader.py``, which
replaces the reference's ``DataLoader(bs, shuffle=True, drop_last=True,
num_workers=8)`` (train/train.py:76-78). Differences, by design:

- Threads instead of worker processes, with a bounded prefetch queue so
  decode overlaps device compute. The port decodes with its own codecs
  (``data.decode``): numpy's transforms and zlib release the GIL, but
  the JPEG Huffman walk and the PNG filter loop hold it where PIL
  releases it for the whole decode, so the threads overlap decodes only
  in part; a decode-once cache (the CLIs' ``--cache``) takes the decode
  out of the epoch.
- Batches are dicts of stacked **uint8 HWC numpy arrays**; all float
  conversion / resize / augmentation happens on the device
  (ops/preprocess.py), not per-sample on host.
- Deterministic per-(epoch, index) sampling via ``np.random.SeedSequence``
  instead of global ``random`` state (reference sketch_dataset.py:294-297).
- ``use_native=True`` decodes each batch in one call on a pool of
  decode processes (``data.native_loader``, the counterpart of JAX's C++
  batch decoder), bitwise the threaded path's images, behind JAX's four
  gates and warning.
"""

from __future__ import annotations

import inspect
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from imageretrievalresearch_tpu_torch.data import native_loader
from imageretrievalresearch_tpu_torch.data.decode import resize_bilinear_host


class TripletLoader:
    """Iterates dict batches over any of the *ImageDataset classes.

    Dataset must expose ``__len__`` and ``__getitem__(idx, rng=...)``
    returning ``{'qry': u8 HWC, 'pos': [u8 HWC], 'neg': [u8 HWC],
    'cat_idx': int, 'prod_idx': int}`` (or the TripleDataset's P/S/N/L dict,
    which is translated).

    Args:
      host_size: if set, resize decoded images to (host_size, host_size)
        on the host (Pillow's bilinear, ``resize_bilinear_host``) so
        variable-size sources stack into one array. Sketchy DB-256 is
        uniform 256px, so the default (None) stacks directly.
      use_native: decode each batch in one ``decode_resize_batch`` call
        on a pool of ``num_workers`` decode processes (kept for one pass
        over the data), when JAX's four gates pass: the pool starts, a
        ``host_size`` is set, the dataset has a ``TripletIndex`` and no
        per-sample ``transform_dic``; otherwise JAX's warning names the
        failed gates and the threaded path runs.
    """

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 seed: int = 42, host_size: int | None = None,
                 prefetch: int = 4, use_native: bool = False,
                 process_index: int = 0, process_count: int = 1):
        """``batch_size`` is the GLOBAL batch size. In a multi-process run
        pass the process's index and the process count: each process
        decodes only its contiguous ``batch_size / process_count`` slice of
        every global batch (SURVEY.md §2 "host data loading sharded
        per-process"), and the per-(epoch, idx) sample
        RNG keeps the global batch composition identical to a
        single-process run."""
        assert batch_size % max(1, process_count) == 0, (
            "the process count must divide the global batch size")
        self.process_index = process_index
        self.process_count = max(1, process_count)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.host_size = host_size
        # queue.Queue(maxsize=0) means UNBOUNDED — the opposite of the
        # bounded readahead this parameter promises
        self.prefetch = max(1, prefetch)
        self.epoch = 0
        # probe once whether __getitem__ accepts the deterministic
        # per-(epoch, idx) rng; a per-fetch `except TypeError` would also
        # swallow genuine TypeErrors raised INSIDE an rng-accepting
        # dataset and retry them nondeterministically without the rng
        try:
            params = inspect.signature(dataset.__getitem__).parameters
            self._pass_rng = "rng" in params or any(
                p.kind is inspect.Parameter.VAR_KEYWORD
                for p in params.values())
        except (TypeError, ValueError):
            self._pass_rng = False
        # the decode pool: needs a TripletIndex dataset, a fixed host_size,
        # no per-sample python transforms, and a pool that starts
        self.use_native = False
        if use_native:
            gates = {
                "decode pool unavailable": native_loader.native_available(),
                "host_size not set": host_size is not None,
                "dataset has no TripletIndex": getattr(
                    dataset, "index", None) is not None,
                "dataset carries per-sample python transforms": getattr(
                    dataset, "transform_dic", None) is None,
            }
            self.use_native = all(gates.values())
            if not self.use_native:
                # say which gate failed: a silent downgrade makes the user
                # attribute the threaded path's throughput to the pool
                why = "; ".join(k for k, ok in gates.items() if not ok)
                print(f"[loader] WARNING: use_native requested but falling "
                      f"back to the threaded decode path: {why}")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        nb = -(-n // self.batch_size)
        if self.process_count > 1 and nb:
            # a final batch smaller than the process count is dropped
            # entirely (see the per-batch slicing in __iter__)
            final = n - (nb - 1) * self.batch_size
            if final // self.process_count == 0:
                nb -= 1
        return nb

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # --- sample fetch ---

    def _fetch(self, idx: int) -> dict:
        ss = np.random.SeedSequence(entropy=self.seed,
                                    spawn_key=(self.epoch, idx))
        rng = np.random.default_rng(ss)
        if self._pass_rng:
            item = self.dataset.__getitem__(idx, rng=rng)
        else:
            item = self.dataset[idx]
        if "P" in item:  # TripleDataset dict -> canonical triplet dict
            item = {"qry": item["P"], "pos": [item["S"]], "neg": [item["N"]],
                    "cat_idx": item["L"], "prod_idx": item["L"]}
        return item

    def _resize_host(self, im: np.ndarray) -> np.ndarray:
        if self.host_size is None:
            return im
        s = self.host_size
        if im.shape[0] == s and im.shape[1] == s:
            return im
        return resize_bilinear_host(im, (s, s))

    def _collate(self, items: list[dict]) -> dict:
        if "image" in items[0]:
            # single-image classification items (ImageFolderDataset):
            # {'image': u8 HWC, 'label': int} -> stacked batch
            return {
                "image": np.stack([self._resize_host(np.asarray(i["image"]))
                                   for i in items]),
                "label": np.asarray([i["label"] for i in items],
                                    dtype=np.int32),
            }

        def stack(key, sub=None):
            if sub is None:
                arrs = [self._resize_host(np.asarray(i[key])) for i in items]
            else:
                arrs = [self._resize_host(np.asarray(i[key][sub])) for i in items]
            return np.stack(arrs)

        n_pos = len(items[0]["pos"])
        n_neg = len(items[0]["neg"])
        batch = {
            "qry": stack("qry"),
            # reference indexes batch['pos'][0] (train/train.py:191); we keep
            # the list-of-stacks layout for pos_return_num/neg_return_num > 1
            "pos": [stack("pos", j) for j in range(n_pos)],
            "neg": [stack("neg", j) for j in range(n_neg)],
            "cat_idx": np.asarray([i["cat_idx"] for i in items], dtype=np.int32),
            "prod_idx": np.asarray([i["prod_idx"] for i in items], dtype=np.int32),
        }
        return batch

    def _native_batch(self, indices: np.ndarray, pool) -> dict:
        """Sample the triplets' paths here, decode the whole batch in one
        call on the decode pool. The dataset's decode cache is bypassed,
        as JAX's C++ path bypasses it."""
        ds = self.dataset
        pn = getattr(ds, "pos_return_num", 1)
        nn = getattr(ds, "neg_return_num", 1)
        samples = []
        for idx in indices.tolist():
            ss = np.random.SeedSequence(entropy=self.seed,
                                        spawn_key=(self.epoch, idx))
            samples.append(ds.index.sample(idx, np.random.default_rng(ss),
                                           pn, nn))
        paths: list[str] = []
        for s in samples:
            paths.append(s["qry"])
            paths.extend(s["pos"])
            paths.extend(s["neg"])
        s_len = 1 + pn + nn
        hs = self.host_size
        # strict: a decode failure raises (as the threaded path's decode
        # does) instead of silently training on gray-filled slots
        imgs = native_loader.decode_resize_batch(paths, hs, hs, strict=True,
                                                 pool=pool)
        imgs = imgs.reshape(len(samples), s_len, hs, hs, 3)
        return {
            "qry": imgs[:, 0],
            "pos": [imgs[:, 1 + j] for j in range(pn)],
            "neg": [imgs[:, 1 + pn + j] for j in range(nn)],
            "cat_idx": np.asarray([s["cat_idx"] for s in samples],
                                  dtype=np.int32),
            "prod_idx": np.asarray([s["prod_idx"] for s in samples],
                                   dtype=np.int32),
        }

    # --- iteration with bounded prefetch ---

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence(entropy=self.seed,
                                       spawn_key=(self.epoch, 1 << 30)))
            rng.shuffle(order)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]
        if self.process_count > 1:
            # contiguous per-process slice of each GLOBAL batch: process r
            # owns rows [r*per, (r+1)*per), the global batch's row order.
            # `per` is computed PER BATCH (not from batch_size): a
            # drop_last=False partial final batch must still split into
            # EQUAL local slices, because every process must make the same
            # run/skip decision for the collective eval step, and the
            # collectives need uniform local shapes — up to process_count-1 trailing rows of a partial
            # batch are dropped (identically on every process). A batch
            # smaller than the process count yields empty slices and is
            # dropped entirely (again identically everywhere).
            def _slice(b: np.ndarray) -> np.ndarray:
                per = len(b) // self.process_count
                lo = self.process_index * per
                return b[lo:lo + per]

            batches = [s for s in map(_slice, batches) if len(s)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # bounded-timeout put so an abandoned consumer (stop set, queue
            # full) never leaves this thread blocked forever holding decoded
            # batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # always enqueue a terminal item — an exception here must not
            # leave the consumer blocked on q.get() forever
            try:
                # the native path's decode pool lives for this pass: it is
                # closed at the pass's end or when the consumer stops
                if self.use_native:
                    pool = native_loader.DecodePool(self.num_workers)

                    def make(bidx):
                        return self._native_batch(bidx, pool)
                else:
                    pool = ThreadPoolExecutor(self.num_workers)

                    def make(bidx):
                        return self._collate(list(pool.map(self._fetch,
                                                           bidx.tolist())))
                with pool:
                    for bidx in batches:
                        if stop.is_set():
                            return
                        if not put(make(bidx)):
                            return
            except BaseException as e:  # noqa: BLE001 - relayed to consumer
                put(e)
            else:
                put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
