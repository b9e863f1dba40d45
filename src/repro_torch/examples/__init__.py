"""Runnable examples of the port (``python -m repro_torch.examples.<name>``):
`quickstart`, `serve_paged` and `train_100m`. Each runs on the card
unless given ``--device cpu``."""
