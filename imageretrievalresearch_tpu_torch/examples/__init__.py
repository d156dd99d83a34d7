"""Runnable walkthroughs on the port (``python -m
imageretrievalresearch_tpu_torch.examples.<name>``): ``serving_pipeline``,
``training_analysis`` and ``score_booster_demo``. Each runs on the card
unless given ``--device cpu``."""
