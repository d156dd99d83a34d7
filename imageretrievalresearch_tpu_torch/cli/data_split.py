"""Dataset split CLI — the reference's ``data_split`` entry (README.md:30-40).

Counterpart of ``imageretrievalresearch_tpu/cli/data_split.py``: the same
flags, and for the same tree and seed the same JSON.

    python -m imageretrievalresearch_tpu_torch.cli.data_split \
        --data_dir /data/sketchy_database_256 --out_path split.json \
        --layout sketchy --policy cat --no-hard_split
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Dataset split")
    p.add_argument("--data_dir", required=True)
    p.add_argument("--out_path", required=True)
    p.add_argument("--layout", default="sketchy",
                   choices=["sketchy", "original", "soft"])
    p.add_argument("--policy", default="cat", choices=["cat", "prod"])
    p.add_argument("--hard_split", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--train_essentials", default="",
                   help="csv of class names pinned to train")
    p.add_argument("--split", type=float, nargs="+", default=[0.8, 0.1, 0.1])
    p.add_argument("--sketch_qry", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    return p


def run(args) -> None:
    from imageretrievalresearch_tpu_torch.data import (
        data_split_original,
        data_split_sketchy,
        data_split_soft,
    )

    if args.layout == "sketchy":
        out = data_split_sketchy(args.data_dir, args.out_path,
                                 policy=args.policy,
                                 hard_split=args.hard_split,
                                 train_essentials=args.train_essentials,
                                 split=args.split, sketch_qry=args.sketch_qry,
                                 seed=args.seed)
    elif args.layout == "original":
        out = data_split_original(args.data_dir, args.out_path,
                                  policy=args.policy,
                                  hard_split=args.hard_split,
                                  train_essentials=args.train_essentials,
                                  split=args.split, seed=args.seed)
    else:
        out = data_split_soft(args.data_dir, args.out_path,
                              policy=args.policy, split=args.split,
                              seed=args.seed)
    print(f"Split written to {out}")


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
