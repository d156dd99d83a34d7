"""Checkpoint conversion CLI: torch / Lightning checkpoint <-> the port.

Counterpart of ``imageretrievalresearch_tpu/cli/convert.py``, with its
flags. Forward (the default, ``--to native``): the reference's published
checkpoints (checkpoints/checkpoints_path.txt), or any timm-naming torch
state dict of a supported family, become a directory in the port's own
checkpoint layout (``utils.checkpoint.CheckpointManager``: ``best/0/`` and
``last/0/``, each a ``state.pt`` whose ``model`` entry is the backbone's
state dict), which ``models.convert.load_checkpoint``, ``cli.inference
-cp`` and ``cli.gallery build --checkpoint`` read:

    python -m imageretrievalresearch_tpu_torch.cli.convert \\
        --checkpoint epoch=22-...ckpt --model_name efficientnet_b3a \\
        --num_classes 125 --out converted/effb3a

Reverse (``--to torch``): a checkpoint of the port (a ``Trainer`` run
directory, or a converted one) or a torch file becomes a timm-naming
torch state dict (``models.convert.export_timm_state_dict``), so a model
trained on the port loads into the reference's torch tooling
(inference/inference.py:114-124) and into the JAX package's
``load_checkpoint``; ``--lightning_out`` wraps it as the published
checkpoints are (``model.`` keys inside a ``state_dict`` entry):

    python -m imageretrievalresearch_tpu_torch.cli.convert \\
        --checkpoint saved_models/run1 --model_name efficientnet_b3a \\
        --num_classes 125 --to torch --lightning_out --out exported.ckpt

The port writes no orbax: ``--to orbax`` is refused with the JAX
package's command. ``--device`` (the port's own flag, as the gallery
CLI's) is where the backbone is built: ``cuda`` by default, raising
without a card unless ``--device cpu``. No forward runs: the weights only
pass through the device on their way from one file to the other.
"""

from __future__ import annotations

import argparse

import torch

from imageretrievalresearch_tpu_torch.models import create_model
from imageretrievalresearch_tpu_torch.models.convert import (
    export_timm_state_dict,
    load_checkpoint,
)
from imageretrievalresearch_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)

# the native directory's one save: step 0, ranked by its step (nothing
# was measured)
_MONITOR = "step"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="torch <-> port conversion")
    p.add_argument("--checkpoint", required=True,
                   help="torch/Lightning checkpoint path, or (--to torch) "
                        "a port checkpoint directory")
    p.add_argument("--model_name", required=True)
    p.add_argument("--num_classes", type=int, default=125)
    p.add_argument("--out", required=True,
                   help="output path: the port's checkpoint directory "
                        "(--to native) or a torch checkpoint file "
                        "(--to torch)")
    p.add_argument("--image_size", type=int, default=224,
                   help="JAX's init shape; accepted, the port needs none")
    p.add_argument("--conv_input", action="store_true")
    p.add_argument("--not_lightning", action="store_true",
                   help="plain torch state dict (no 'model.' prefix strip)")
    p.add_argument("--lenient", action="store_true",
                   help="allow missing/unused keys")
    p.add_argument("--to", choices=("native", "torch", "orbax"),
                   default="native",
                   help="output format: the port's checkpoint directory "
                        "(default) or a timm-naming torch state dict "
                        "(.pth/.ckpt); orbax is the JAX package's")
    p.add_argument("--lightning_out", action="store_true",
                   help="with --to torch: wrap as a Lightning-style ckpt "
                        "('model.'-prefixed keys inside a state_dict "
                        "payload, the published-checkpoint layout)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device the backbone is built on (default: "
                        "cuda; raises without a GPU unless --device cpu)")
    return p


def check_args(parser: argparse.ArgumentParser,
               args: argparse.Namespace) -> None:
    if args.lightning_out and args.to != "torch":
        parser.error("--lightning_out requires --to torch (the default "
                     "--to native output has no Lightning wrapping)")
    if args.to == "orbax":
        parser.error("--to orbax writes the JAX package's format: run "
                     "python -m imageretrievalresearch_tpu.cli.convert "
                     "(the port writes --to native or --to torch)")


def run(args: argparse.Namespace, device=None) -> str:
    """Convert as ``args`` say; returns the path written. ``device``
    (else ``args.device``, else ``cuda``) is where the backbone is
    built."""
    device = device if device is not None else args.device
    backbone = create_model(args.model_name, num_classes=args.num_classes,
                            conv_input=args.conv_input, device=device)
    load_checkpoint(args.checkpoint, backbone,
                    from_pytorch_lightning=not args.not_lightning,
                    strict=not args.lenient)
    if args.to == "torch":
        sd = export_timm_state_dict(backbone, lightning=args.lightning_out,
                                    strict=not args.lenient)
        torch.save({"state_dict": sd} if args.lightning_out else sd,
                   args.out)
    else:
        model = {k: v.detach().cpu() for k, v in
                 backbone.state_dict().items()}
        CheckpointManager(args.out, monitor=_MONITOR, mode="max").save(
            0, {"model": model, "step": 0}, {_MONITOR: 0})
    print(f"Converted {args.checkpoint} -> {args.out}")
    return args.out


def main(argv: list[str] | None = None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_args(parser, args)
    run(args)


if __name__ == "__main__":
    main()
