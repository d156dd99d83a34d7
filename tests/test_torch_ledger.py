"""The kernel layer's ledger (``ops/_cuda.py``) on the CPU: ``launch`` on a
stub C entry with the device lookups replaced, ``plain_on_card``,
``record`` and ``ledger`` blocks."""

import sys
import threading
from types import SimpleNamespace

import pytest
import torch

from imageretrievalresearch_tpu_torch.ops import _cuda


@pytest.fixture
def launch(monkeypatch):
    """``launch(err)``: ``image_histogram`` launched on a stub of its C
    entry that returns CUDA error ``err``, on card 0's null stream."""
    err = [0]
    monkeypatch.setitem(_cuda._ENTRIES, ("image_ops", "image_histogram"),
                        lambda *args: err[0])
    monkeypatch.setattr(_cuda, "device_index", lambda device: 0)
    monkeypatch.setattr(_cuda, "stream_handle", lambda index: 0)
    monkeypatch.setattr(_cuda, "error_string", lambda code, name: "stub")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def call(code=0):
        err[0] = code
        _cuda.launch("image_ops", "image_histogram", torch.device("cpu"),
                     torch.zeros(4, dtype=torch.uint8), 1, 4, None)
    return call


def test_ledger_counts_successful_launches_and_nested_blocks_see_their_own(
        launch):
    with _cuda.ledger() as outer:
        launch()
        with _cuda.ledger() as inner:
            launch()
            launch()
            with pytest.raises(RuntimeError, match="image_histogram launch "
                               "failed: CUDA error 700 \\(stub\\)"):
                launch(700)
        assert not outer    # filled when its block exits
        launch()
    assert inner == {"image_histogram": 2}
    assert outer == {"image_histogram": 4}


@pytest.mark.parametrize("device,counted", [("cuda", True), ("cpu", False)])
def test_plain_version_counts_on_the_card_only(device, counted):
    """``plain:<entry>`` for a CUDA tensor only (a stand-in: no card here);
    ``record`` counts its key on any device."""
    with _cuda.ledger() as got:
        _cuda.plain_on_card("dw_conv_grad_x",
                            SimpleNamespace(device=torch.device(device)))
        _cuda.record("nhwc_copy")
    assert got == ({"plain:dw_conv_grad_x": 1} if counted else {}) | {
        "nhwc_copy": 1}


def test_ledger_reads_and_counts_across_concurrent_threads():
    """Threads counting at once (a server's handlers launching), each count
    under a key new to the ledger, while this thread opens and closes
    blocks: no read fails and no count is lost, with the interpreter
    switching threads as often as it can."""
    threads, per_thread = 4, 20000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cuda.ledger() as got:
            workers = [threading.Thread(target=lambda t=t: [
                _cuda.record(f"stress{t}.{i}") for i in range(per_thread)])
                for t in range(threads)]
            for w in workers:
                w.start()
            while any(w.is_alive() for w in workers):
                with _cuda.ledger():
                    pass
            for w in workers:
                w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(switch)
    assert len(got) == threads * per_thread and set(got.values()) == {1}
