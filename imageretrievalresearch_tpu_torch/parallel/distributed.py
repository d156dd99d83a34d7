"""The process group that multi-device training runs over, and its
launcher.

The JAX package trains on one controller driving every local device
(``jax.distributed`` adds one controller per host). The port uses torch's
idiom: one process per device, joined by a ``torch.distributed`` process
group. The group uses NCCL when its devices are CUDA cards and gloo on the
CPU; a caller may ask for gloo on cards (two ranks sharing one card, which
NCCL refuses with ``ncclInvalidUsage``): gloo carries every collective
used here on CUDA tensors (all-reduce, broadcast, all-gather, barrier).

- :func:`init_group` / :func:`destroy_group` start and stop the group of
  this process, one device per rank; a CUDA group without a card raises,
  and a failed NCCL start raises as it is (never retried on gloo).
- :func:`rank`, :func:`world_size`, :func:`local_device`: this process's
  place (rank 0 of 1 outside a group). :func:`process_index` /
  :func:`process_count` are ``jax.process_index`` / ``process_count``:
  the ranks of a group started from the multi-host flags each load their
  own slice of every batch (``multi_host=True``); the workers of one
  :func:`launch` count as one process, each holding the whole batch.
- :func:`launch` starts one fresh interpreter per rank (``python -m`` this
  module, never a fork and never the caller's ``__main__``), each of which
  joins the group and calls an importable function; a rank that fails or
  outlives its timeout fails the launch.
- :func:`all_gather_rows` / :func:`mean_over_group` / :func:`broadcast`:
  the collectives the training steps need.
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Sequence

import torch
import torch.distributed as dist

# the directory that holds the package, for the workers' import path
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_MODULE = "imageretrievalresearch_tpu_torch.parallel.distributed"
# a collective that waits longer than this raises (a rank that died)
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class _Group:
    device: torch.device
    multi_host: bool


_GROUP: _Group | None = None


def free_port() -> int:
    """A free TCP port on localhost, for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_group(*, world_size: int, rank: int, init_method: str,
               device: str | torch.device = "cuda",
               backend: str | None = None, multi_host: bool = False,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the group as ``rank`` of ``world_size`` at ``init_method``
    (``tcp://host:port``), running on ``device``: ``"cuda"`` takes card
    ``LOCAL_RANK`` (else ``rank`` modulo the visible cards), ``"cuda:i"``
    card i, ``"cpu"`` the CPU. ``backend`` defaults to NCCL on a card and
    gloo on the CPU."""
    global _GROUP
    if _GROUP is not None or dist.is_initialized():
        raise RuntimeError("this process is already in a process group")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a CUDA process group needs "
                               "a card; pass device='cpu' for a gloo group "
                               "on the CPU")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            device = torch.device("cuda", local)
        torch.cuda.set_device(device)
        from imageretrievalresearch_tpu_torch._device import (
            set_float32_precision,
        )
        set_float32_precision()
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kw)
    _GROUP = _Group(device, multi_host)


def destroy_group() -> None:
    """Leave the group (nothing outside one)."""
    global _GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GROUP = None


def in_group() -> bool:
    return _GROUP is not None


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def local_device() -> torch.device:
    """This rank's device (raises outside a group)."""
    if _GROUP is None:
        raise RuntimeError("not in a process group")
    return _GROUP.device


def process_count() -> int:
    """Processes that each load their own slice of a batch
    (``jax.process_count``): the group's size when it was started from
    the multi-host flags, else 1."""
    return world_size() if _GROUP is not None and _GROUP.multi_host else 1


def process_index() -> int:
    return rank() if process_count() > 1 else 0


def barrier() -> None:
    if in_group():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[local_device().index])
        else:
            dist.barrier()


# ------------------------------------------------------------ collectives

def group_size(group=None) -> int:
    """The ranks of ``group`` (None: the whole group; 1 outside one)."""
    return dist.get_world_size(group) if in_group() else 1


@torch.no_grad()
def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` (the same shape on each) concatenated on dim 0
    in rank order, over ``group`` (None: the whole group; a mesh's
    ``batch_group``: the ranks that hold distinct rows), without
    gradient; ``x`` itself outside a group or over one rank."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.contiguous()
    out = torch.empty((n * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out


@torch.no_grad()
def mean_over_group(values: dict[str, torch.Tensor], group=None
                    ) -> dict[str, torch.Tensor]:
    """Each scalar averaged over the ranks of ``group`` (as
    :func:`all_gather_rows`), in one all-reduce (f32)."""
    n = group_size(group)
    if n == 1 or not values:
        return values
    keys = list(values)
    flat = torch.stack([values[k].detach().float().reshape(())
                        for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= n
    return {k: flat[i] for i, k in enumerate(keys)}


def broadcast(value: Any, src: int = 0) -> Any:
    """A picklable value as rank ``src`` holds it, on every rank."""
    if world_size() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=src)
    return box[0]


# --------------------------------------------------------------- launcher

def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def launch(target: str, world_size: int, payload: Any = None, *,
           devices: Sequence[str], backend: str | None = None,
           timeout_s: float | None = None,
           env: dict[str, str] | None = None) -> list:
    """Run ``target`` (``"module:function"``, importable by name) on
    ``world_size`` fresh worker processes, rank r on ``devices[r]``, each
    in one group (``backend`` as :func:`init_group` picks it). Each rank
    calls ``function(payload)``; returns the ranks' results in rank
    order. Rank 0 writes to this process's stdout and stderr, the others
    to log files whose end a failure reports. A rank that exits nonzero,
    or a launch that outlives ``timeout_s`` (None: no limit but the
    group's: a collective that waits ``DEFAULT_TIMEOUT_S`` raises in its
    rank), stops every rank and raises ``RuntimeError``."""
    module = target.split(":", 1)[0]
    if module == "__main__" or ":" not in target:
        raise ValueError(f"launch target {target!r} must be "
                         "'module:function' of an importable module (not "
                         "__main__: the workers never import the caller's "
                         "main script)")
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    work = tempfile.mkdtemp(prefix="irt_launch_")
    torch.save(payload, os.path.join(work, "payload.pt"))
    spec = {"target": target, "world_size": world_size,
            "backend": backend, "devices": [str(d) for d in devices],
            "init_method": f"tcp://localhost:{free_port()}"}
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    wenv = {**os.environ, **(env or {})}
    wenv["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + [p for p in (wenv.get("PYTHONPATH") or "").split(
            os.pathsep) if p])
    procs, logs = [], []
    try:
        for r in range(world_size):
            log = None if r == 0 else os.path.join(work, f"rank{r}.log")
            out = None if log is None else open(log, "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", _MODULE, work, str(r)], env=wenv,
                stdin=subprocess.DEVNULL, stdout=out,
                stderr=None if out is None else subprocess.STDOUT))
            if out is not None:
                out.close()
        deadline = (None if timeout_s is None
                    else time.monotonic() + timeout_s)
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                # the others fail at their next collective: let them
                time.sleep(1.0)
                break
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"the launch of {target} on "
                                   f"{world_size} ranks outlived its "
                                   f"{timeout_s:.0f} s timeout")
            time.sleep(0.05)
        failed = {r: p.poll() for r, p in enumerate(procs)
                  if p.poll() not in (None, 0)}
        if failed:
            raise RuntimeError(
                f"rank(s) {sorted(failed)} of {world_size} exited with "
                f"codes {list(failed.values())}; the launch is stopped"
                + "".join(f"\nrank {r}'s log ends:\n{_tail(logs[r])}"
                          for r in failed if logs[r]))
        return [torch.load(os.path.join(work, f"result{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(work, ignore_errors=True)


def _worker(work: str, r: int) -> None:
    """One rank of :func:`launch`: join the group, call the target, save
    its result, leave the group."""
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    init_group(world_size=spec["world_size"], rank=r,
               init_method=spec["init_method"],
               device=spec["devices"][r], backend=spec["backend"])
    try:
        payload = torch.load(os.path.join(work, "payload.pt"),
                             map_location="cpu", weights_only=False)
        module, name = spec["target"].split(":", 1)
        fn = getattr(importlib.import_module(module), name)
        result = fn(payload)
        torch.save(result, os.path.join(work, f"result{r}.pt"))
        barrier()
    finally:
        destroy_group()


if __name__ == "__main__":
    # the package's module, not this __main__ copy, holds the group state
    # that the target's code reads
    importlib.import_module(_MODULE)._worker(sys.argv[1], int(sys.argv[2]))
