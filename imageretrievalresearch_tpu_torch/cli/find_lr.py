"""LR-finder CLI — the reference's train/find_lr.py capability.

Counterpart of ``imageretrievalresearch_tpu/cli/find_lr.py`` on one card.
Runs the exponential LR range test (Lightning tuner equivalent,
train/find_lr.py:435-436), prints the suggestion, then optionally trains
with it (``--train_after``): the find_lr recipe logs its validation
``cos_sims`` through the score booster (train/find_lr.py:87-95,337) and
pickles test results with the reference's keys (train/find_lr.py:440-457).

The sweep runs the Trainer's own path on raw loader batches: the batch
transform on the device, ``Trainer._prepare`` and a train step built for
the sweep's schedule, so the suggested lr reflects real training
arithmetic. Each sweep starts from the model's initial weights, and so
does ``--train_after``.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from imageretrievalresearch_tpu_torch.cli.train import (
        build_parser as base,
    )
    p = base()
    p.description = "LR range test"
    p.add_argument("--min_lr", type=float, default=1e-8)
    p.add_argument("--max_lr", type=float, default=1.0)
    p.add_argument("--num_lr_steps", type=int, default=100)
    p.add_argument("--train_after", action="store_true",
                   help="train with the suggested lr after the sweep")
    return p


def run(args: argparse.Namespace) -> dict:
    import functools
    import os

    from imageretrievalresearch_tpu_torch.cli.train import (
        build_config,
        build_dataset,
        build_loader,
        check_ported,
    )

    # the same refusals and --recipe handling as the train CLI (this
    # parser inherits both flag groups)
    check_ported(args)

    from imageretrievalresearch_tpu_torch.models import create_model
    from imageretrievalresearch_tpu_torch.train import (
        Trainer,
        build_classifier_train_step,
        build_train_step,
    )
    from imageretrievalresearch_tpu_torch.train.lr_finder import lr_find
    from imageretrievalresearch_tpu_torch.utils.analysis import (
        find_lr_cos_sim_score,
    )

    cfg = build_config(args, vars(build_parser().parse_args([])))

    # the shared train-CLI builders handle every --dataset family, so the
    # sweep runs the same loader/task (triplet or CE-classifier) the real
    # training run would
    ds = build_dataset(cfg, args, "train")
    loader = build_loader(cfg, args, ds, "train")
    val_ds = build_dataset(cfg, args, "val")
    val_loader = build_loader(cfg, args, val_ds, "val") if val_ds else None
    backbone = create_model(cfg.model_name, num_classes=ds.get_cat_length(),
                            device=cfg.device, seed=cfg.seed)
    # reference eps/alpha for the booster (train/find_lr.py:87)
    booster = functools.partial(find_lr_cos_sim_score, eps=5, alpha=1,
                                mode="for_pos")
    trainer = Trainer(cfg, backbone, loader, val_loader,
                      metric_transforms={"cos_sims": booster})
    init = {k: v.detach().clone() for k, v in backbone.state_dict().items()}
    build_step = (build_classifier_train_step
                  if cfg.effective_task == "classification"
                  else build_train_step)
    swept = {}
    transform_gen, dropout_gen = trainer._generators(0)

    def make_state(schedule):
        # a fresh state: the initial weights, a new optimizer at step 0,
        # and a step that takes its lr from the sweep's schedule
        backbone.load_state_dict(init)
        swept["step"] = build_step(cfg, schedule)
        return trainer.init_state()

    def sweep_step(state, batch, generator):
        # raw host batches, transformed per step exactly as
        # Trainer.train_epoch does: lr_find keeps every batch for replay,
        # and device-resident ones would pin num_lr_steps batches on the
        # card for the whole sweep
        return swept["step"](state, trainer._prepare(
            trainer.transform(batch, generator)), dropout_gen)

    out = lr_find(make_state, sweep_step, loader, transform_gen,
                  min_lr=args.min_lr, max_lr=args.max_lr,
                  num_steps=args.num_lr_steps)
    print(f"Suggested lr: {out['suggestion']}")
    if args.train_after and out["suggestion"]:
        backbone.load_state_dict(init)
        cfg.learning_rate = out["suggestion"]
        save_name = (f"{cfg.model_name}_{cfg.optimizer_name}_"
                     f"{cfg.learning_rate:.6g}")
        cfg.checkpoint_dir = os.path.join(cfg.save_path, save_name)
        from imageretrievalresearch_tpu_torch.utils.logging import (
            MetricLogger,
        )
        logger = MetricLogger(cfg.checkpoint_dir, use_wandb=cfg.wandb,
                              run_name=save_name,
                              log_every_n_steps=cfg.log_every_n_steps)
        trainer2 = Trainer(cfg, backbone, loader, val_loader, logger=logger,
                           metric_transforms={"cos_sims": booster})
        state, _ = trainer2.fit()
        test_ds = build_dataset(cfg, args, "test")
        if test_ds is not None:
            # reference: trainer.test on the test split, results pickled
            # under results/ with the run name (train/find_lr.py:440-457);
            # only the sketchy-family datasets carry a test split
            test_loader = build_loader(cfg, args, test_ds, "test")
            results_path = os.path.join(
                cfg.save_path, "results", f"{save_name}_results.pickle")
            results = trainer2.test(state, test_loader,
                                    results_path=results_path,
                                    score_booster=booster)
            print(f"Results of the training are saved in {results_path}")
            out["test_results"] = results
    return out


def main() -> None:
    run(build_parser().parse_args())


if __name__ == "__main__":
    main()
