"""End-to-end serving walkthrough on a synthetic Sketchy tree, on the port.

Counterpart of the repo's ``examples/serving_pipeline.py``. The reference
has no serving story — its notebook re-embeds the full gallery inside
every analysis run (inference/training_analysis.ipynb cell 2). This
example shows the lifecycle a deployment uses:

1. build a synthetic Sketchy-layout tree (stand-in for the real dataset),
2. embed its sketch gallery once with ``cli.inference`` and persist a
   compact ``GalleryIndex`` artifact (int8 storage: quarter the bytes of
   f32),
3. load the artifact and rank query images through ``cli.gallery query``
   in the int8 and int8_rerank modes (on the card, 32 or more queries
   against 256 or more items take the fused int8 top-k kernel),
4. start the resident HTTP endpoint and answer a live request.

    python -m imageretrievalresearch_tpu_torch.examples.serving_pipeline \
        [--workdir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import threading
import urllib.request


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "serving_demo"))
    p.add_argument("--image_size", type=int, default=32)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    dev = ["--device", args.device] if args.device else []

    from imageretrievalresearch_tpu_torch.cli.gallery import (
        _make_server,
        build_parser as gallery_parser,
        run as gallery_run,
    )
    from imageretrievalresearch_tpu_torch.cli.inference import (
        build_parser as inference_parser,
        run as inference_run,
    )
    from imageretrievalresearch_tpu_torch.data.synthetic import (
        make_sketchy_tree,
    )

    # 1. data (replace with the real Sketchy DB-256 root in production)
    tree = make_sketchy_tree(os.path.join(args.workdir, "sketchy"),
                             n_cats=3, n_prods=1, n_photos=8,
                             n_sketches=4, size=args.image_size)
    npz = os.path.join(args.workdir, "gallery.npz")

    # 2. embed + persist the gallery (int8 artifact; pass -cp <ckpt> for a
    #    trained model — architecture/transform get recorded in the meta)
    inference_run(inference_parser().parse_args([
        "-ip", tree, "-mn", "efficientnet_b0",
        "-is", str(args.image_size), "-bs", "8",
        "--save_gallery", npz, "--gallery_dtype", "int8", *dev,
    ]))

    # 3. batch query via the CLI surface (JSON lines on stdout): int8
    #    (quarter the bytes) and int8_rerank (int8 shortlist + true-f32
    #    re-rank of its two-level codes; --shortlist sizes stage 1)
    photos = sorted(glob.glob(tree + "/photo/tx_000000000000/*/*"))[:2]
    gallery_run(gallery_parser().parse_args(
        ["query", npz, *photos, "-k", "24", "--num_unique", "2",
         "--matmul_dtype", "int8", *dev]))
    gallery_run(gallery_parser().parse_args(
        ["query", npz, *photos, "-k", "8", "--num_unique", "2",
         "--matmul_dtype", "int8_rerank", "--shortlist", "16", *dev]))

    # 4. resident HTTP endpoint
    srv = _make_server(gallery_parser().parse_args(
        ["serve", npz, "--port", "0", "-k", "24", "--num_unique", "2",
         "--matmul_dtype", "int8", *dev]))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        with open(photos[0], "rb") as f:
            body = f.read()
        req = urllib.request.Request(f"{base}/search?num_unique=2",
                                     data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            print("HTTP /search ->", json.dumps(json.loads(r.read())),
                  file=sys.stderr)
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)


if __name__ == "__main__":
    main()
