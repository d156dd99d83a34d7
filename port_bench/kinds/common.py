"""What every kind of cell shares: its outcome, the device's description,
limits read from the workload file, and freeing the program before the
reference runs."""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import torch

from port_bench.trace import Reading


@dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict
    checks: dict
    device: dict
    reading: Reading = field(default_factory=lambda: Reading(None))
    # every number read against the reference, compared or not
    readings: dict = field(default_factory=dict)


def precise(on: bool = True) -> None:
    """True float32 products and convolutions (TF32 off), or TF32 on."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def device_info(device, chips: int, peak_bytes: int, trace=None,
                busy_s: float | None = None) -> dict:
    """The result's ``device``; a CPU run (the tests') says so."""
    on_card = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": chips, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        info["busy_s"] = trace.busy_s if busy_s is None else busy_s
        info["window_s"] = trace.window_s
    return info


def peak_bytes(device) -> int:
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    """Return what the program held to the device (its objects must be
    unreferenced by then)."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def checks(values: dict, workload: dict) -> dict:
    """``{name: {"value": v, "limit": l}}`` for each number the workload
    file gives a limit, in its order; the other readings are printed on
    standard error, for the record, and not compared. A limit without a
    reading is an error."""
    limits = workload["limits"]
    missing = set(limits) - set(values)
    if missing:
        raise KeyError(f"no reading for the limits {sorted(missing)}")
    for k, v in values.items():
        if k not in limits:
            print(f"reading {k} {float(v)!r} (not compared)",
                  file=sys.stderr)
    return {k: {"value": float(values[k]), "limit": float(limits[k]["limit"])}
            for k in limits}


def phase(name: str, start: float) -> None:
    """A set-up phase's end, in seconds since ``start``, on standard
    error."""
    print(f"setup {name} {time.perf_counter() - start:.3f} s",
          file=sys.stderr, flush=True)
