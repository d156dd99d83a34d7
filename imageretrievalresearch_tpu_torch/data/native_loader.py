"""Batch image decode on a pool of worker processes.

Counterpart of ``imageretrievalresearch_tpu/data/native_loader.py``, which
binds a C++ thread pool over libjpeg and libpng. The port keeps its
contract: ``decode_resize_batch(paths, h, w)`` decodes and resizes a list
of JPEG / PNG files into one (N, h, w, 3) uint8 array; a failed decode is
filled with 128, or raises ``IOError`` with ``strict``; ``native_available``
says whether the fast path can run. The work runs on a pool of processes
over the port's own decoders (``data.decode``: ``decode_image``, then
Pillow's bilinear ``resize_bilinear_host`` where the size differs):
processes and not threads, because the JPEG Huffman walk is Python and
holds the GIL. The decoders are the in-process path's, so a batch is
bitwise what ``decode_image`` + ``resize_bilinear_host`` give in this
process (JAX's C++ path only comes close to PIL).

Each worker is a fresh interpreter (``python -m`` this module), started
with ``subprocess``, never forked: it is safe after CUDA is initialised,
it imports ``data.decode`` (numpy, not torch) and never the caller's main
module, so a script needs no ``__main__`` guard. Requests and results
cross its stdin and stdout as pickles, one file at a time. A
:class:`DecodePool` keeps its processes across batches (the loader holds
one per pass over the data); a call without one starts a pool for that
call.
"""

from __future__ import annotations

import functools
import os
import pickle
import subprocess
import sys
import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from imageretrievalresearch_tpu_torch.data.decode import (
    decode_image,
    resize_bilinear_host,
)

# the value a failed decode is filled with (JAX's C++ and PIL paths)
FILL = 128
# the directory that holds the package, for the workers' import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _decode_one(path: str, h: int, w: int):
    """(pid, (h, w, 3) uint8 or None, error text): one file decoded and
    resized in a worker (or in this process, as the fallback)."""
    try:
        img = decode_image(path)
        if img.shape[:2] != (h, w):
            img = resize_bilinear_host(img, (h, w))
        return os.getpid(), img, ""
    except Exception as e:  # noqa: BLE001 - reported per file
        return os.getpid(), None, f"{type(e).__name__}: {e}"


def _stop(procs: list) -> None:
    """End the workers: close their stdin (they exit at EOF), then wait;
    kill one that has not exited."""
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()


class DecodePool:
    """``num_threads`` decode processes (0: ``os.cpu_count()``), kept until
    :meth:`close` (or the end of a ``with`` block, or the pool's garbage
    collection). ``pids`` holds the workers that have decoded a file."""

    def __init__(self, num_threads: int = 0):
        self.size = num_threads if num_threads > 0 else os.cpu_count() or 1
        self.pids: set[int] = set()
        self._procs: list[subprocess.Popen] = []
        self._stopper = None

    def start(self) -> "DecodePool":
        """Start every worker and wait until each has imported the
        decoders (its first message is its pid)."""
        if self._procs:
            return self
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "imageretrievalresearch_tpu_torch.data."
             "native_loader"], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env) for _ in range(self.size)]
        self._stopper = weakref.finalize(self, _stop, self._procs)
        for p in self._procs:
            try:
                pickle.load(p.stdout)
            except EOFError:
                self.close()
                raise RuntimeError("a decode worker exited at start-up")
        return self

    def map(self, paths: list[str], h: int, w: int) -> list:
        """``_decode_one`` of every path, in order; each worker takes the
        next path as soon as it is free (one feeding thread per worker)."""
        self.start()
        results: list = [None] * len(paths)
        order = iter(range(len(paths)))
        lock = threading.Lock()

        def feed(proc):
            while True:
                with lock:
                    i = next(order, None)
                if i is None:
                    return
                pickle.dump((paths[i], h, w), proc.stdin)
                proc.stdin.flush()
                try:
                    results[i] = pickle.load(proc.stdout)
                except EOFError:
                    raise RuntimeError(f"decode worker {proc.pid} exited "
                                       f"while decoding {paths[i]}")

        with ThreadPoolExecutor(self.size) as feeders:
            for f in [feeders.submit(feed, p) for p in self._procs]:
                f.result()
        self.pids.update(pid for pid, _, _ in results)
        return results

    def close(self) -> None:
        if self._stopper is not None:
            self._stopper()
        self._procs, self._stopper = [], None

    def __enter__(self) -> "DecodePool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@functools.cache
def native_available() -> bool:
    """Whether a decode pool starts here (tried once per process, with one
    worker)."""
    try:
        with DecodePool(1) as pool:
            pool.start()
        return True
    except (OSError, RuntimeError):
        return False


def decode_resize_batch(paths: list[str], h: int, w: int,
                        *, num_threads: int = 0,
                        allow_fallback: bool = True,
                        strict: bool = False,
                        pool: DecodePool | None = None) -> np.ndarray:
    """(N, h, w, 3) uint8 from image paths, decoded on ``pool`` (or on a
    pool of ``num_threads`` processes started for this call; 0 means
    ``os.cpu_count()``).

    Without a pool (none given and none can start) the batch is decoded
    in this process when ``allow_fallback``, else ``RuntimeError``.
    ``strict=True`` raises ``IOError`` on any failed decode, naming the
    files (the training loader uses it, so that ``--use_native_loader``
    cannot turn a loud decode error into gray slots); otherwise a failed
    slot is filled with 128."""
    paths = [os.fspath(p) for p in paths]
    if pool is not None:
        results = pool.map(paths, h, w)
    elif native_available():
        with DecodePool(num_threads) as own:
            results = own.map(paths, h, w)
    elif allow_fallback:
        results = [_decode_one(p, h, w) for p in paths]
    else:
        raise RuntimeError("decode pool unavailable")
    out = np.empty((len(paths), h, w, 3), dtype=np.uint8)
    failed = []
    for i, (path, (_, img, err)) in enumerate(zip(paths, results)):
        if img is None:
            failed.append(f"{path} ({err})")
            out[i] = FILL
        else:
            out[i] = img
    if strict and failed:
        raise IOError(f"decode pool: {len(failed)} of {len(paths)} images "
                      f"failed to decode: {'; '.join(failed[:4])}")
    return out


def _worker() -> None:
    """A worker's loop: its pid first, then one result per (path, h, w)
    request until stdin closes. Stdout carries only the pickles (anything
    printed goes to stderr)."""
    out = os.fdopen(os.dup(sys.stdout.fileno()), "wb")
    os.dup2(sys.stderr.fileno(), sys.stdout.fileno())
    inp = sys.stdin.buffer
    pickle.dump(os.getpid(), out)
    out.flush()
    while True:
        try:
            request = pickle.load(inp)
        except EOFError:
            return
        pickle.dump(_decode_one(*request), out,
                    protocol=pickle.HIGHEST_PROTOCOL)
        out.flush()


if __name__ == "__main__":
    _worker()
