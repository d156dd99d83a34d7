"""Script equivalent of the reference's inference/training_analysis.ipynb,
on the port.

Counterpart of the repo's ``examples/training_analysis.py``. The
notebook's flow (cells 0-4): build the test dataloader, load a trained
checkpoint (embedding-only head), embed every (qry, pos, neg) triplet,
rank each query against the full positive-sketch gallery with
``topk(cos, k=150)``, dedup to the first 3 unique classes, report
top1/top3, and render retrieval panels (query + retrieved sketches with
cosine-similarity captions). Here each cell is a call of the port:

    python -m imageretrievalresearch_tpu_torch.examples.training_analysis \
        --ims_path <sketchy_db_256> [--split_json split.json] \
        [--checkpoint model.ckpt] [--model_name efficientnet_b3a] \
        [--viz_dir analysis_out/] [--gradcam] [--save_gallery gallery.npz] \
        [--device cpu]

Works with reference torch/Lightning checkpoints and the port's trainer
checkpoint directories (``models.convert.load_checkpoint``).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--ims_path", required=True)
    p.add_argument("--split_json", default=None)
    p.add_argument("--checkpoint", default="")
    p.add_argument("--model_name", default="efficientnet_b3a")
    p.add_argument("--input_size", type=int, default=224)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--topk", type=int, default=150)
    p.add_argument("--viz_dir", default=None)
    p.add_argument("--gradcam", action="store_true",
                   help="overlay retrieval-pair Grad-CAM on the panels")
    p.add_argument("--save_gallery", default=None,
                   help="persist the sketch gallery as a GalleryIndex .npz")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv: list[str] | None = None) -> dict:
    """Run the notebook's cells; returns the class-dedup results."""
    args = build_parser().parse_args(argv)

    from imageretrievalresearch_tpu_torch._device import resolve_device
    from imageretrievalresearch_tpu_torch.data import (
        SketchyImageDataset,
        TripletLoader,
    )
    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.models.convert import (
        load_checkpoint,
    )
    from imageretrievalresearch_tpu_torch.ops.preprocess import (
        build_eval_transform,
    )
    from imageretrievalresearch_tpu_torch.retrieval import (
        GalleryIndex,
        RetrievalEngine,
        grad_cam_pair,
        retrieval_grid,
    )

    device = resolve_device(args.device)

    # cell 1: dataset + loader (test split)
    kw = dict(data_dir=args.ims_path)
    if args.split_json:
        kw.update(trainval_json=args.split_json, trainval="test")
    ds = SketchyImageDataset(load_images=True, **kw)
    dl = TripletLoader(ds, args.batch_size, shuffle=False, num_workers=8)
    print(f"test samples: {len(ds)}, classes: {ds.get_cat_length()}")

    # cell 2: model + checkpoint (embedding-only: the notebook sets
    # model.head = Identity(); `embed` is that surface here)
    backbone = create_model(args.model_name,
                            num_classes=ds.get_cat_length(), device=device)
    load_checkpoint(args.checkpoint, backbone)
    engine = RetrievalEngine(
        backbone, device=device,
        transform=build_eval_transform("squarepad", args.input_size,
                                       device=device))

    # cell 2 (cont.): embed + rank + unique-class dedup
    embeds = engine.embed_triplet_loader(
        dl, keep_images=args.viz_dir is not None)
    results = engine.evaluate_class_dedup(embeds, k=args.topk)
    print(f"top1: {results['top1']:.4f}")
    print(f"top3: {results['top3']:.4f}")
    print(f"mean cos(qry, pos): {results['scores']:.4f}")
    print(f"mean cos(qry, neg): {results['neg_scores']:.4f}")

    if args.save_gallery:
        gal = GalleryIndex(embeds["fms_poss_all"].shape[1], device=device,
                           meta={"model": args.model_name,
                                 "checkpoint": args.checkpoint})
        gal.add(embeds["fms_poss_all"], embeds["classes_all"])
        gal.save(args.save_gallery)
        print(f"saved {len(gal)}-item gallery to {args.save_gallery}")

    # cell 4: retrieval gallery visualization (+ optional Grad-CAM)
    if args.viz_dir:
        cams = None
        if args.gradcam:
            n = min(8, len(results["ims"]))
            q = engine.transform(results["ims"][:n])
            ref = results["fms_poss_all"][:n]
            cams = grad_cam_pair(backbone, q, ref)
        idx_to_clss = {v: k for k, v in ds.cat_idx.items()}
        paths = retrieval_grid(results, idx_to_clss, args.viz_dir,
                               cams=cams)
        print(f"wrote {len(paths)} panels to {args.viz_dir}")
    return results


if __name__ == "__main__":
    main()
