"""Training of the port: the optimizer (``state``), checkpoints
(``checkpoint``), the Stage-1 autoencoder trainer (``ae_trainer``; CLI
``python -m arbitrarystyletransfer_tpu_torch.train_autoencoder``), the
Stage-2 AST trainer (``ast_trainer``; CLI ``python -m
arbitrarystyletransfer_tpu_torch.train``) and BatchNorm recalibration for
serving (``recalibrate``)."""
