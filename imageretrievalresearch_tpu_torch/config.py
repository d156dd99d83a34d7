"""One typed configuration for training and inference.

Counterpart of ``imageretrievalresearch_tpu/config.py``: the reference's
argparse surface with its flag names and defaults. ``loss_mode`` is the
reference's only_features / only_labels triad (train/train.py:105-111)
plus the T3 contrastive recipe.

The port runs on one CUDA card: ``device`` defaults to ``"cuda"``, and
``compute_dtype="bfloat16"`` means ``torch.autocast`` in bf16 around the
forward and the losses (parameters and optimizer state stay f32).
``num_devices`` > 1 and ``param_sharding="fsdp"`` are not ported yet: the
``Trainer`` raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

LOSS_MODES = ("cos_ce", "cos_con_ce", "cos_only", "ce_only")


@dataclasses.dataclass
class TrainConfig:
    # --- reference train.py CLI flags (names preserved) ---
    expdir: str | None = None                 # -ed
    save_path: str = "saved_models"           # -sp
    batch_size: int = 64                      # -bs
    device: str = "cuda"                      # -d (reference: 'cuda:1')
    ims_path: str = "path/to/your/data"       # -ip
    model_name: str = "rexnet_150"            # -mn
    optimizer_name: str = "Adam"              # -on (Adam -> AdamW, or SGD)
    learning_rate: float = 4.7863e-03         # -lr ("from find_lr")
    weight_decay: float = 1e-5                # -wd
    only_feature_embeddings: bool | None = True   # -ofm
    only_target_labels: bool | None = True        # -otl

    # --- recipe knobs that were hardcoded per script ---
    cos_margin: float = 0.5        # CosineEmbeddingLoss margin (T1/T2: 0.5,
                                   # T3: 0.3, T4: 0.2)
    con_margin: float = 0.3        # ContrastiveLoss margin (T3)
    use_contrastive: bool = False  # T3 recipe adds ContrastiveLoss
    milestones: Sequence[int] = (6, 12, 20, 30, 35, 40)  # MultiStepLR epochs
    lr_gamma: float = 0.1
    max_epochs: int = 300
    early_stop_patience: int = 10
    monitor: str = "cos_sims"      # checkpoint/early-stop metric, mode max
    monitor_mode: str = "max"
    seed: int = 42                 # pl.seed_everything(42)
    log_every_n_steps: int = 15
    save_top_k: int = 1

    # --- data ---
    split_json: str | None = None
    dataset: str = "sketchy"       # sketchy | original | soft | triple |
                                   # imagefolder
    val_fraction: float = 0.2
    task: str | None = None        # "triplet" | "classification"; None =
                                   # inferred from `dataset`
    pos_policy: str = "cat"
    neg_policy: str = "except_cat"
    num_workers: int = 8
    image_size: int = 224
    autoaugment: bool = False      # T2/T3 train transforms

    # --- device knobs (no reference counterpart) ---
    compute_dtype: str = "bfloat16"   # autocast type (reference: fp16 AMP)
    num_devices: int | None = None    # one card; > 1 is not ported yet
    param_sharding: str = "replicated"  # fsdp is not ported yet
    checkpoint_dir: str | None = None
    wandb: bool = False
    profile_dir: str | None = None    # torch.profiler trace of early steps

    @property
    def effective_task(self) -> str:
        """Explicit ``task`` wins; otherwise the dataset family implies it
        (imagefolder = the single-image CE classifier; all others =
        triplet)."""
        if self.task is not None:
            if self.task not in ("triplet", "classification"):
                raise ValueError(f"task must be 'triplet' or "
                                 f"'classification', got {self.task!r}")
            return self.task
        return ("classification" if self.dataset == "imagefolder"
                else "triplet")

    @property
    def loss_mode(self) -> str:
        """The reference's only_features/only_labels triad
        (train/train.py:105-111) + the T3 contrastive recipe."""
        of, ol = self.only_feature_embeddings, self.only_target_labels
        if not (of or ol):
            raise ValueError(
                "Please choose at least one loss function to train the "
                "model (triplet loss or crossentropy loss)")
        if of and ol:
            return "cos_con_ce" if self.use_contrastive else "cos_ce"
        if of:
            return "cos_only"
        return "ce_only"


@dataclasses.dataclass
class InferenceConfig:
    # reference inference.py CLI flags (inference/inference.py:266-272)
    im_path: str = "data"                     # -ip
    checkpoint_path: str = ""                 # -cp
    model_name: str = "rexnet_150"            # -mn
    input_size: int = 224                     # -is
    batch_size: int = 256                     # -bs
    device: str = "cuda"                      # -d
    cache: bool = True                        # -c
    conv_input: bool = False                  # load_checkpoint conv stem
    num_classes: int = 0
    topk_variant: str = "class_dedup"         # class_dedup | index_match
    split_json: str | None = None
