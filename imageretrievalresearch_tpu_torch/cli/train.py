"""Training CLI — flag parity with reference train/train.py:480-498.

Counterpart of ``imageretrievalresearch_tpu/cli/train.py``.
Usage (same surface as README.md:100):

    python -m imageretrievalresearch_tpu_torch.cli.train \
        --batch_size 64 --optimizer_name Adam --learning_rate 3e-4 \
        --model_name efficientnet_b3a --ims_path /data/sketchy_database_256

Recipe knobs that the reference hardcoded per script are exposed as extra
flags (--cos_margin / --con_margin / --use_contrastive / --autoaugment),
so T1-T5 are configs of one trainer rather than five scripts.

The flags, shorthands and defaults are JAX's, except ``-d/--device``: it
defaults to ``cuda`` and is where the trainer runs (``--device cpu`` runs
on the CPU; without a card and without it the CLI raises).
``--use_native_loader`` decodes each batch on a pool of ``--num_workers``
decode processes (``data.native_loader``), bitwise the default path's
images, behind JAX's gates and warning.

Across cards: with ``num_devices`` at its default (every visible card)
the trainer launches one worker process per card, each loading every
batch whole and training on its rows. Across hosts (or processes): each
process passes ``--coordinator_address host:port --num_processes N
--process_id i`` and drives one card (``LOCAL_RANK``, else ``i`` modulo
the visible cards); the processes form one ``torch.distributed`` group
(NCCL, gloo with ``--device cpu``) and each loads its slice of every
batch. ``--param_sharding fsdp`` shards the state over the ranks of one
launch (FSDP2); with ``--num_processes`` > 1 it raises, as JAX's trainer
does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import re


def _bool_or_none(v: str) -> bool | None:
    # the reference used type=bool (always truthy for non-empty strings);
    # we parse properly but accept the same spellings
    if v in ("None", "none", ""):
        return None
    return v not in ("False", "false", "0")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Triplet Loss (PyTorch port) Training Arguments")
    # reference flags (train/train.py:483-495), names/shorthands preserved
    p.add_argument("-ed", "--expdir", default=None,
                   help="Experiment directory")
    p.add_argument("-sp", "--save_path", type=str, default="saved_models",
                   help="Path to save trained models")
    p.add_argument("-bs", "--batch_size", type=int, default=64)
    p.add_argument("-d", "--device", type=str, default="cuda",
                   help="Device the trainer runs on: cuda (the default) or "
                        "cpu")
    p.add_argument("-ip", "--ims_path", type=str, default="path/to/your/data")
    p.add_argument("-mn", "--model_name", type=str, default="rexnet_150")
    p.add_argument("-on", "--optimizer_name", type=str, default="Adam")
    p.add_argument("-lr", "--learning_rate", type=float, default=4.7863e-03)
    p.add_argument("-wd", "--weight_decay", type=float, default=1e-5)
    p.add_argument("-ofm", "--only_feature_embeddings", type=_bool_or_none,
                   default=True)
    p.add_argument("-otl", "--only_target_labels", type=_bool_or_none,
                   default=True)
    # recipe knobs (hardcoded per reference script)
    p.add_argument("--cos_margin", type=float, default=0.5)
    p.add_argument("--con_margin", type=float, default=0.3)
    p.add_argument("--use_contrastive", action="store_true",
                   help="T3 recipe: add ContrastiveLoss")
    p.add_argument("--autoaugment", action="store_true",
                   help="AutoAugment ImageNetPolicy train transforms (T2/T3)")
    p.add_argument("--split_json", type=str, default=None,
                   help="train/val/test split json (see cli.data_split)")
    p.add_argument("--dataset", type=str, default="sketchy",
                   choices=["sketchy", "original", "soft", "triple",
                            "imagefolder"],
                   help="imagefolder = class-per-subfolder classification "
                        "tree (the T5 recipe's ImageFolder surface, "
                        "train/train_vit_crossentropy.py:50); triple = the "
                        "T4 photo/+sketch/ class-folder triplet layout "
                        "(data/triplet_dataset.py) with a seeded "
                        "--val_fraction holdout")
    p.add_argument("--val_fraction", type=float, default=0.2,
                   help="imagefolder train/val holdout (reference "
                        "random_split 80/20)")
    p.add_argument("--task", type=str, default=None,
                   choices=["triplet", "classification"],
                   help="override the task implied by --dataset "
                        "(imagefolder implies the CE classifier, all "
                        "others the triplet embedder)")
    p.add_argument("--pos_policy", type=str, default="cat")
    p.add_argument("--neg_policy", type=str, default="except_cat")
    p.add_argument("--sketch_qry", action="store_true",
                   help="sketches become queries too (sketchy layout)")
    p.add_argument("--pos_return_num", type=int, default=1)
    p.add_argument("--neg_return_num", type=int, default=1)
    p.add_argument("--use_native_loader", action="store_true",
                   help="decode each batch on a pool of --num_workers "
                        "processes (needs --host_size or --image_size; "
                        "falls back with a warning otherwise)")
    p.add_argument("--coordinator_address", type=str, default=None,
                   help="multi-host: the process group's rendezvous "
                        "host:port (set with --num_processes/--process_id;"
                        " all three together)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("-c", "--cache", action="store_true",
                   help="decode-once RAM cache at host size (the "
                        "reference's inference cache flag, applied to "
                        "training): on a decode-bound host this makes "
                        "steady-state epochs device-bound")
    p.add_argument("--host_size", type=int, default=None,
                   help="host-side decode size (default: image_size). Set "
                        "to the source resolution (e.g. 256 for Sketchy) to "
                        "defer the final resize to the device's antialiased "
                        "path")
    p.add_argument("--recipe", type=str, default=None,
                   help="named preset (T1-T6): "
                        "train / train_efficientnet / "
                        "train_efficient_cos_con_ce_loss / train_vit_triplet"
                        " / train_vit_crossentropy / find_lr")
    p.add_argument("--max_epochs", type=int, default=300)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--param_sharding", type=str, default="replicated",
                   choices=("replicated", "fsdp"),
                   help="state layout over the process group: replicated "
                        "(DDP, the reference's strategy) or fsdp (ZeRO-3: "
                        "params+optimizer sharded over the ranks by FSDP2, "
                        "~1/n_devices state bytes per card)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--wandb", action="store_true")
    return p


# --------------------------------------------------- the argument print

# yaml.resolver's implicit types: a plain scalar matching one of these
# would not read back as a string, so yaml.dump quotes it
_IMPLICIT = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON"
    r"|off|Off|OFF"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|<<|~|null|Null|NULL|=|"
    r"[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?(?:[Tt]|[ \t]+)"
    r"[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
    r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_WIDTH = 80          # yaml.dump's best_width
_INDENT = 2          # a value's continuation lines


def _string_style(s: str) -> str:
    """yaml's emitter for a one-line printable ASCII string in block
    context: '' (plain), "'" or '"' (the rest, escaped as JSON does)."""
    if any(not (" " <= ch <= "~") for ch in s):
        return '"'
    if not s or _IMPLICIT.match(s):
        return "'"
    plain = not (s[0] == " " or s[-1] == " " or s.startswith(("---", "...")))
    if plain and (s[0] in "#,[]{}&*!|>'\"%@`"
                  or (s[0] in "?:-" and (len(s) == 1 or s[1] == " "))):
        plain = False
    for i, ch in enumerate(s[1:], start=1):
        after = i + 1 >= len(s) or s[i + 1] == " "
        if (ch == ":" and after) or (ch == "#" and s[i - 1] == " "):
            plain = False
    return "" if plain else "'"


def _folded(text: str, column: int, quote: str) -> str:
    """yaml's write_plain / write_single_quoted: words as they come, a
    single space replaced by a line break where the column has passed
    the width (single-quoted: not at the ends; ' doubled)."""
    out, col = [], column
    i, n = 0, len(text)
    while i < n:
        j = i
        while j < n and text[j] == " ":
            j += 1
        if j > i:                       # a run of spaces
            if (j - i == 1 and col > _WIDTH
                    and (not quote or (i != 0 and j != n))):
                out.append("\n" + " " * _INDENT)
                col = _INDENT
            else:
                out.append(text[i:j])
                col += j - i
            i = j
            continue
        while j < n and text[j] != " ":
            j += 1
        word = text[i:j].replace("'", "''") if quote else text[i:j]
        out.append(word)
        col += len(word)
        i = j
    return "".join(out)


def _yaml_value(v, column: int) -> str:
    """A scalar as yaml.dump writes it, starting at ``column``."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    s = str(v)
    style = _string_style(s)
    if style == '"':
        return json.dumps(s)
    if style == "'":
        return "'" + _folded(s, column + 1, "'") + "'"
    return _folded(s, column, "")


def yaml_dump(mapping: dict) -> str:
    """``yaml.dump(mapping, default_flow_style=False)`` for a flat mapping
    of None, bools, numbers, strings and lists of them, written without
    PyYAML: keys sorted, lists as block sequences, strings plain where
    yaml leaves them plain, else single-quoted, folded at yaml's width.
    Strings with line breaks or characters outside printable ASCII are
    written double-quoted with JSON escapes (yaml folds those
    otherwise)."""
    lines = []
    for key in sorted(mapping):
        v = mapping[key]
        if isinstance(v, (list, tuple)):
            if not v:
                lines.append(f"{key}: []")
                continue
            lines.append(f"{key}:")
            lines += [f"- {_yaml_value(x, 2)}" for x in v]
        else:
            lines.append(f"{key}: {_yaml_value(v, len(key) + 2)}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------- builders

# one shared TripleDataset decode cache per (tree, cache_size), replaced
# when the key changes so one stale tree's decoded images never accumulate
# across runs in the same process
_TRIPLE_CACHE: dict = {"key": None, "store": None}


def _shared_triple_store(ims_path: str, cache_size) -> dict:
    import os as _os
    key = (_os.path.abspath(ims_path), cache_size)
    if _TRIPLE_CACHE["key"] != key:
        _TRIPLE_CACHE["key"] = key
        _TRIPLE_CACHE["store"] = {}
    return _TRIPLE_CACHE["store"]


def build_dataset(cfg, args, split: str):
    """One dataset for ``split`` ("train"/"val"/"test") per the configured
    ``cfg.dataset`` family — shared by the train and find_lr CLIs so every
    ``--dataset`` choice behaves identically in both. Returns None when the
    family has no such split (sketchy-family val/test without
    ``--split_json``; imagefolder/triple have no test split)."""
    import os

    from imageretrievalresearch_tpu_torch.data import (
        ImageFolderDataset,
        OriginalImageDataset,
        SketchyImageDataset,
        TripleDataset,
        TripletImageDataset,
    )

    cache_kw = (dict(load_images=True,
                     cache_size=args.host_size or cfg.image_size)
                if args.cache else {})
    if cfg.dataset == "imagefolder":
        # T5 surface: any class-per-subfolder tree, seeded 80/20 holdout
        # (reference ImageFolder + random_split,
        # train/train_vit_crossentropy.py:50,59)
        if split == "test":
            return None
        return ImageFolderDataset(data_dir=cfg.ims_path, split=split,
                                  val_fraction=cfg.val_fraction,
                                  seed=cfg.seed, **cache_kw)
    if cfg.dataset == "triple":
        # T4 surface: <ims_path>/photo/<class>/* + <ims_path>/sketch/<class>/*
        # (reference train/train_vit_triplet.py:17,52 — TripleDataset with a
        # random train/val holdout, here seeded)
        if split == "test":
            return None
        if args.cache:
            # TripleDataset's sketch universe is split-independent (pos/neg
            # drawn by class): share ONE decode cache across the CLI's
            # train/val instances so the tree is decoded + held once
            cache_kw["cache_store"] = _shared_triple_store(
                cfg.ims_path, cache_kw["cache_size"])
        return TripleDataset(
            photo_root=os.path.join(cfg.ims_path, "photo"),
            sketch_root=os.path.join(cfg.ims_path, "sketch"),
            seed=cfg.seed, split=split, val_fraction=cfg.val_fraction,
            **cache_kw)
    ds_cls = {"sketchy": SketchyImageDataset,
              "original": OriginalImageDataset,
              "soft": TripletImageDataset}[cfg.dataset]
    if split != "train" and not cfg.split_json:
        return None
    kw = dict(data_dir=cfg.ims_path, pos_policy=cfg.pos_policy,
              neg_policy=cfg.neg_policy, **cache_kw)
    if cfg.dataset == "sketchy" and getattr(args, "sketch_qry", False):
        kw["sketch_qry"] = True
    if getattr(args, "pos_return_num", 1) != 1:
        kw["pos_return_num"] = args.pos_return_num
    if getattr(args, "neg_return_num", 1) != 1:
        kw["neg_return_num"] = args.neg_return_num
    if cfg.split_json:
        kw.update(trainval_json=cfg.split_json, trainval=split)
    return ds_cls(**kw)


def build_loader(cfg, args, ds, kind: str = "train"):
    """Loader with the per-split conventions both CLIs share: train
    shuffles and drops the remainder; imagefolder/triple validation mirrors
    the reference's random_split DataLoaders (shuffle=False, drop_last=False,
    train_vit_crossentropy.py:63, train_vit_triplet.py:52) so eval order is
    deterministic and the partial final batch is scored exactly; test keeps
    every item. Where each process loads its own slice (the multi-host
    flags), the loader yields this process's slice of every batch."""
    from imageretrievalresearch_tpu_torch.parallel import distributed
    from imageretrievalresearch_tpu_torch.data import TripletLoader

    seed_offset = {"train": 0, "val": 1, "test": 2}[kind]
    if kind == "train":
        conv = dict(shuffle=True, drop_last=True)
    elif kind == "test":
        conv = dict(shuffle=False, drop_last=False)
    else:
        conv = (dict(shuffle=False, drop_last=False)
                if cfg.dataset in ("imagefolder", "triple")
                else dict(shuffle=True, drop_last=True))
    return TripletLoader(ds, cfg.batch_size, num_workers=cfg.num_workers,
                         seed=cfg.seed + seed_offset,
                         host_size=args.host_size or cfg.image_size,
                         use_native=args.use_native_loader,
                         process_index=distributed.process_index(),
                         process_count=distributed.process_count(), **conv)


def init_distributed(args: argparse.Namespace) -> bool:
    """JAX's multi-host bring-up from the shared CLI flags: this process
    joins the group as ``--process_id`` of ``--num_processes`` at
    ``tcp://--coordinator_address``, one device per process (NCCL on a
    card, gloo with ``--device cpu``). The three flags go together (the
    port has no auto-detection); FSDP over several processes raises before
    the group starts, as JAX's trainer refuses it. Returns whether a
    group was started. Shared by the train and find_lr CLIs."""
    flags = (args.coordinator_address, args.num_processes, args.process_id)
    if all(f is None for f in flags):
        return False
    if any(f is None for f in flags):
        raise ValueError("--coordinator_address, --num_processes and "
                         "--process_id go together (the port does not "
                         "detect them)")
    n, pid = args.num_processes, args.process_id
    if n < 1 or not 0 <= pid < n:
        raise ValueError(f"--process_id {pid} of --num_processes {n}")
    if args.param_sharding == "fsdp" and n > 1:
        raise NotImplementedError(
            "param_sharding='fsdp' is single-process (single-controller) "
            "only; multi-process runs use replicated state")
    from imageretrievalresearch_tpu_torch.parallel import distributed

    distributed.init_group(world_size=n, rank=pid,
                           init_method=f"tcp://{args.coordinator_address}",
                           device=args.device, multi_host=True)
    print(f"[distributed] process {distributed.rank()} of "
          f"{distributed.world_size()}, 1 local / "
          f"{distributed.world_size()} global devices")
    return True


@contextlib.contextmanager
def check_ported(args: argparse.Namespace):
    """Refuse, before any work, what the port cannot run (``--device
    cuda``, the default, without a card), then hold the multi-host group
    of the flags for the ``with`` block, leaving it at the end."""
    import torch

    from imageretrievalresearch_tpu_torch.parallel import distributed

    if (torch.device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError("no CUDA device: the CLI trains on the GPU by "
                           "default; pass --device cpu to run on the CPU")
    started = init_distributed(args)
    try:
        yield
    finally:
        if started:
            distributed.destroy_group()


def build_config(args: argparse.Namespace, parser_defaults: dict):
    """TrainConfig from CLI args, honoring ``--recipe`` presets: explicit
    CLI values override the preset; untouched argparse defaults do not.
    Shared by the train and find_lr CLIs."""
    from imageretrievalresearch_tpu_torch.config import TrainConfig

    cfg_fields = {f for f in TrainConfig.__dataclass_fields__}
    overrides = {k: v for k, v in vars(args).items() if k in cfg_fields}
    if getattr(args, "recipe", None):
        from imageretrievalresearch_tpu_torch.recipes import make_config
        explicit = {k: v for k, v in overrides.items()
                    if parser_defaults.get(k) != v}
        return make_config(args.recipe, **explicit)
    return TrainConfig(**overrides)


def run(args: argparse.Namespace):
    """Train as JAX's CLI does; returns ``Trainer.fit``'s (state,
    history)."""
    with check_ported(args):
        return _run(args)


def _run(args: argparse.Namespace):
    # heavy imports deferred so --help is instant
    import os

    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.train import Trainer
    from imageretrievalresearch_tpu_torch.utils.logging import MetricLogger

    print(f"\nTraining Arguments:\n{yaml_dump(vars(args))}")

    cfg = build_config(args, vars(build_parser().parse_args([])))
    tr_ds = build_dataset(cfg, args, "train")
    val_ds = build_dataset(cfg, args, "val")
    num_classes = tr_ds.get_cat_length()
    if cfg.effective_task != "classification" and cfg.loss_mode == "ce_only":
        # ce_only targets PRODUCT labels (reference train.py:236-241 uses
        # `regs`), so the head must be product-sized. The reference sizes
        # every head by cat count (train.py:64), which torch rejects loudly
        # ("Target out of bounds") the moment prods > cats; we implement
        # the intent instead of the crash.
        prod_classes = getattr(tr_ds, "get_prod_length",
                               tr_ds.get_cat_length)()
        if prod_classes != num_classes:
            print(f"[train] ce_only trains on product labels: classifier "
                  f"head sized {prod_classes} (products), not "
                  f"{num_classes} (categories)")
            num_classes = prod_classes
    print(f"Number of train set images: {len(tr_ds)}")
    if val_ds:
        print(f"Number of validation set images: {len(val_ds)}")
    print(f"\nTrain dataset has {num_classes} classes")

    train_loader = build_loader(cfg, args, tr_ds, "train")
    val_loader = (build_loader(cfg, args, val_ds, "val")
                  if val_ds else None)

    save_name = f"{cfg.model_name}_{cfg.optimizer_name}_{cfg.learning_rate}"
    cfg.checkpoint_dir = os.path.join(cfg.save_path, save_name)
    backbone = create_model(cfg.model_name, num_classes=num_classes,
                            device=cfg.device, seed=cfg.seed)
    logger = MetricLogger(cfg.checkpoint_dir, use_wandb=cfg.wandb,
                          run_name=save_name,
                          log_every_n_steps=cfg.log_every_n_steps)
    trainer = Trainer(cfg, backbone, train_loader, val_loader, logger=logger)
    return trainer.fit()


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
