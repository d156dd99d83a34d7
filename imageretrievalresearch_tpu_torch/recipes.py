"""Named training recipes: the reference's five scripts as TrainConfig
presets (counterpart of ``imageretrievalresearch_tpu/recipes.py``, the same
table). Anything not listed keeps the TrainConfig defaults."""

from __future__ import annotations

import dataclasses

from imageretrievalresearch_tpu_torch.config import TrainConfig

RECIPES: dict[str, dict] = {
    # T1 train/train.py — rexnet_150, CosineEmbedding(0.5)+CE,
    # MultiStepLR [6,12,20,30,35,40]
    "train": dict(model_name="rexnet_150", cos_margin=0.5,
                  milestones=(6, 12, 20, 30, 35, 40)),
    # T2 train/train_efficientnet.py — efficientnet_b3a + AutoAugment
    "train_efficientnet": dict(model_name="efficientnet_b3a",
                               cos_margin=0.5, autoaugment=True,
                               milestones=(6, 12, 20, 30, 35, 40)),
    # T3 train/train_efficient_cos_con_ce_loss.py — the README's best recipe:
    # cos(0.3)+contrastive(0.3)+CE, MultiStepLR [6,15,22,30,35,40]
    "train_efficient_cos_con_ce_loss": dict(
        model_name="efficientnet_b3a", cos_margin=0.3, con_margin=0.3,
        use_contrastive=True, autoaugment=True,
        milestones=(6, 15, 22, 30, 35, 40)),
    # T4 train/train_vit_triplet.py — swin, embedding-only, cos(0.2) only,
    # MultiStepLR [10,20,30,40,50], lr 1e-5, wd 1e-6, bs 32, on the
    # photo/+sketch/ class-folder TripleDataset layout
    "train_vit_triplet": dict(
        model_name="swin_s3_base_224", cos_margin=0.2,
        only_feature_embeddings=True, only_target_labels=None,
        dataset="triple",
        learning_rate=1e-5, weight_decay=1e-6, batch_size=32,
        milestones=(10, 20, 30, 40, 50)),
    # T5 train/train_vit_crossentropy.py — plain classification on an
    # ImageFolder tree, seeded 80/20 holdout, monitor val_top1, patience 20
    "train_vit_crossentropy": dict(
        model_name="swin_s3_base_224", only_feature_embeddings=None,
        only_target_labels=True, monitor="val_top1",
        dataset="imagefolder", early_stop_patience=20,
        learning_rate=1e-3, batch_size=32,
        milestones=(10, 20, 30, 40, 50)),
    # T6 train/find_lr.py — cos(0.3)+con(0.3)+CE with val_top1 monitor
    "find_lr": dict(model_name="rexnet_150", cos_margin=0.3, con_margin=0.3,
                    use_contrastive=True, monitor="val_top1"),
}


def make_config(recipe: str, **overrides) -> TrainConfig:
    if recipe not in RECIPES:
        raise ValueError(f"unknown recipe {recipe!r}; "
                         f"choose from {sorted(RECIPES)}")
    kw = dict(RECIPES[recipe])
    kw.update(overrides)
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(kw) - fields
    if unknown:
        raise ValueError(f"unknown config fields {sorted(unknown)}")
    return TrainConfig(**kw)
