"""Stage-2 AST training of the port: the optimizer (``state``), checkpoints
(``checkpoint``), the trainer (``ast_trainer``) and its CLI
(``python -m arbitrarystyletransfer_tpu_torch.train``)."""
