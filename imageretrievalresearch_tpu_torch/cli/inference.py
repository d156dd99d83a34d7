"""Inference CLI — flag parity with reference inference/inference.py:265-274.

Counterpart of ``imageretrievalresearch_tpu/cli/inference.py``, with the
same flags, defaults and printed lines. It runs the *working*
retrieval-eval path (the reference script's own dataset import is broken —
SURVEY.md §0; the behavior implemented here is the notebook path of
training_analysis.ipynb cell 2, with the script's index-match metric
available via --topk_variant index_match):

    python -m imageretrievalresearch_tpu_torch.cli.inference \
        -ip /data/sketchy_database_256 -cp model.ckpt -mn rexnet_150

``-d/--device`` defaults to ``cuda`` and is where the model, the eval
transform and the ranking run (``--device cpu`` runs on the CPU; without
a card and without it the CLI raises). On the card, an evaluation of at
least 32 queries against a gallery of at least 256 items ranks through
the fused f32 top-k kernel (``ops.retrieval.cosine_topk``).
"""

from __future__ import annotations

import argparse

import torch

from imageretrievalresearch_tpu_torch.cli.train import (
    _bool_or_none,
    yaml_dump,
)
from imageretrievalresearch_tpu_torch.ops.preprocess import (
    build_eval_transform,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Inference Arguments")
    p.add_argument("-ip", "--im_path", type=str, default="data",
                   help="Images directory")
    p.add_argument("-cp", "--checkpoint_path", type=str, default="",
                   help="Path to the trained model checkpoint")
    p.add_argument("-mn", "--model_name", type=str, default="rexnet_150")
    p.add_argument("-is", "--input_size", type=int, default=224)
    p.add_argument("-bs", "--batch_size", type=int, default=256)
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="Device the evaluation runs on: cuda (the default) "
                        "or cpu")
    p.add_argument("-c", "--cache",
                   type=lambda v: bool(_bool_or_none(v)),
                   default=True, help="Preload/decode-cache images")
    p.add_argument("--conv_input", action="store_true",
                   help="prepend the 3x3 conv + SiLU stem "
                        "(inference.py:101-105)")
    p.add_argument("--split_json", type=str, default=None)
    p.add_argument("--num_classes", type=int, default=None,
                   help="classifier-head size to build the model with "
                        "(default: the dataset's category count). Set to "
                        "the training-time class count (125 for the "
                        "published Sketchy checkpoints) when evaluating a "
                        "checkpoint on a different image tree — retrieval "
                        "uses embeddings only, so the head size need not "
                        "match the query data")
    p.add_argument("--topk_variant", type=str, default="class_dedup",
                   choices=["class_dedup", "index_match"])
    p.add_argument("--transform", type=str, default="squarepad",
                   choices=["squarepad", "plain"],
                   help="'squarepad' = the reference eval pipeline SquarePad"
                        " -> ToTensor -> Normalize(ImageNet) "
                        "(inference/inference.py:48-62); 'plain' = bare "
                        "resize + /255 for framework-trained checkpoints")
    p.add_argument("--host_size", type=int, default=None,
                   help="host-side decode resize (default: stack at source "
                        "resolution so SquarePad sees the true aspect ratio;"
                        " set for ragged-size sources)")
    p.add_argument("--viz_dir", type=str, default=None,
                   help="write retrieval visualization grids here")
    p.add_argument("--save_gallery", type=str, default=None,
                   help="persist the embedded sketch gallery as a "
                        "GalleryIndex .npz (serving artifact: load with "
                        "retrieval.GalleryIndex.load and query without "
                        "re-embedding)")
    p.add_argument("--gallery_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16", "int8"],
                   help="--save_gallery storage dtype (bfloat16/int8 = "
                        "half/quarter artifact size)")
    return p


def run(args: argparse.Namespace) -> dict:
    """Evaluate as JAX's CLI does; returns the evaluation's results
    (:meth:`RetrievalEngine.evaluate_class_dedup` or
    ``evaluate_index_match``)."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the CLI evaluates on the GPU by "
                           "default; pass --device cpu to run on the CPU")
    from imageretrievalresearch_tpu_torch.data import (
        SketchyImageDataset,
        TripletLoader,
    )
    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.models.convert import (
        load_checkpoint,
    )
    from imageretrievalresearch_tpu_torch.retrieval import (
        GalleryIndex,
        RetrievalEngine,
        retrieval_grid,
    )

    print(f"\nInference Arguments:\n{yaml_dump(vars(args))}\n")

    kw = dict(data_dir=args.im_path)
    if args.split_json:
        kw.update(trainval_json=args.split_json, trainval="test")
    ds = SketchyImageDataset(load_images=args.cache, **kw)
    num_classes = ds.get_cat_length()
    print(f"The dataset has {num_classes} classes")
    print(f"Number of test samples: {len(ds)}")
    # 'squarepad' pads at source resolution (so the pad sees the true
    # aspect ratio) then resizes on device; 'plain' pre-resizes on host
    host_size = args.host_size
    if host_size is None and args.transform == "plain":
        host_size = args.input_size
    # evaluation covers every item exactly once: no shuffle, and no
    # dropped remainder (it would leave items out of the metrics and of
    # --save_gallery)
    dl = TripletLoader(ds, args.batch_size, shuffle=False, drop_last=False,
                       num_workers=8, host_size=host_size)

    head_classes = (args.num_classes if args.num_classes is not None
                    else num_classes)
    backbone = create_model(args.model_name, num_classes=head_classes,
                            conv_input=args.conv_input, device=device)
    load_checkpoint(args.checkpoint_path, backbone)
    engine = RetrievalEngine(
        backbone, device=device,
        transform=build_eval_transform(args.transform, args.input_size,
                                       device=device))

    keep = (args.viz_dir is not None
            and args.topk_variant == "class_dedup")
    embeds = engine.embed_triplet_loader(dl, keep_images=keep)
    if args.save_gallery:
        gal = GalleryIndex(embeds["fms_poss_all"].shape[1], device=device,
                           meta={"model": args.model_name,
                                 "checkpoint": args.checkpoint_path,
                                 "transform": args.transform,
                                 "input_size": args.input_size,
                                 # the gallery CLI must rebuild the SAME
                                 # architecture to load the checkpoint
                                 "num_classes": head_classes,
                                 "conv_input": bool(args.conv_input)})
        gal.add(embeds["fms_poss_all"], embeds["classes_all"])
        gal.save(args.save_gallery, store_dtype=args.gallery_dtype)
        print(f"Saved {len(gal)}-item gallery index to {args.save_gallery}")
    if args.topk_variant == "index_match":
        results = engine.evaluate_index_match(embeds)
        print(f"\nTest loss: {results['loss']:.3f}")
    else:
        results = engine.evaluate_class_dedup(embeds)
    print(f"Test top1: {results['top1']:.3f}")
    print(f"Test top3: {results['top3']:.3f}")
    print(f"Test cos sim scores: {results['scores']:.3f}")
    if args.viz_dir:
        if args.topk_variant != "class_dedup":
            # retrieval_grid consumes the class-dedup result keys
            # (ims/topk_inds/...); the index-match results don't carry them
            print("--viz_dir requires --topk_variant class_dedup; "
                  "skipping visualization")
        else:
            idx_to_clss = {v: k for k, v in ds.cat_idx.items()}
            paths = retrieval_grid(results, idx_to_clss, args.viz_dir)
            print(f"Wrote {len(paths)} visualization grids to "
                  f"{args.viz_dir}")
    return results


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
