"""The port's retrieval grids (``retrieval/visualize.py``) on the CPU,
held against the JAX package's ``_to_uint8`` and its panel layout.

``retrieval_grid`` is driven with a hand-made results dict; the figures
it closes are captured (``plt.close`` wrapped) to check each panel: the
query, the positive, one panel per retrieved item (blank for index -1),
and the Grad-CAM column."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from imageretrievalresearch_tpu.retrieval import visualize as J  # noqa: E402
from imageretrievalresearch_tpu_torch.retrieval import visualize as T  # noqa


@pytest.mark.parametrize("case", [
    "uint8", "unit", "overshoot", "past_two", "negative", "float64"])
def test_to_uint8_equals_jax(rng, case):
    im = {"uint8": lambda: rng.integers(0, 256, (5, 7, 3), dtype=np.uint8),
          "unit": lambda: rng.random((5, 7, 3), dtype=np.float32),
          "overshoot": lambda: rng.random((5, 7, 3),
                                          dtype=np.float32) * 1.9,
          "past_two": lambda: rng.random((5, 7, 3),
                                         dtype=np.float32) * 300,
          "negative": lambda: rng.normal(size=(5, 7, 3)).astype(np.float32),
          "float64": lambda: rng.random((5, 7, 3)) * 2.0}[case]()
    got = T._to_uint8(im)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, J._to_uint8(im))


def _results(rng, n=4, k=3, size=12):
    """A class-dedup results dict: n queries, k retrieved columns, the
    last query's last column padded with -1 (its classes ran out)."""
    inds = rng.integers(0, n, (n, k))
    inds[-1, -1] = -1
    return {"ims": rng.random((n, size, size, 3), dtype=np.float32),
            "poss": rng.integers(0, 256, (n, size, size, 3), np.uint8),
            "classes_all": np.arange(n) % 2,
            "topk_inds": inds,
            "top_vals": rng.random((n, k), dtype=np.float32),
            "top_r_list": rng.integers(0, 2, (n, k))}


@pytest.fixture
def figures(monkeypatch):
    """Every figure ``retrieval_grid`` closes, in order."""
    closed = []
    close = plt.close

    def capture(fig=None):
        closed.append(fig)
        close(fig)

    monkeypatch.setattr(plt, "close", capture)
    return closed


@pytest.mark.parametrize("num_queries,num_retrieved,cams", [
    (8, 3, None), (2, 5, "numpy"), (3, 2, "tensor")])
def test_retrieval_grid_panels(rng, tmp_path, figures, num_queries,
                               num_retrieved, cams):
    res = _results(rng)
    maps = rng.random((4, 3, 3), dtype=np.float32)
    cam_arg = {None: None, "numpy": maps,
               "tensor": torch.from_numpy(maps)}[cams]
    paths = T.retrieval_grid(res, {0: "cat", 1: "dog"}, str(tmp_path / "v"),
                             num_queries=num_queries,
                             num_retrieved=num_retrieved, cams=cam_arg)
    n = min(num_queries, 4)
    shown = min(num_retrieved, 3)      # clamped to the dedup columns
    assert paths == [str(tmp_path / "v" / f"retrieval_{i:03d}.png")
                     for i in range(n)]
    assert all((tmp_path / "v" / p).stat().st_size > 0 for p in paths)
    assert len(figures) == n
    for i, fig in enumerate(figures):
        axes = fig.axes
        assert len(axes) == 2 + shown + (cams is not None)
        assert axes[0].get_title() == f"query\n{['cat', 'dog'][i % 2]}"
        assert axes[1].get_title() == "positive"
        for j in range(shown):
            ax = axes[2 + j]
            if res["topk_inds"][i, j] < 0:
                assert not ax.axison and not ax.get_images()
            else:
                assert ax.get_title().startswith(
                    f"cos_sim:{res['top_vals'][i, j]:.3f}\npred: ")
        if cams is not None:
            assert axes[-1].get_title() == "Grad-CAM"
            assert len(axes[-1].get_images()) == 2      # image + overlay
            np.testing.assert_array_equal(
                np.asarray(axes[-1].get_images()[1].get_array()), maps[i])
    # the -1 panel (last query, last column) is shown when both fit
    assert (n, shown) != (4, 3) or not figures[3].axes[4].axison
