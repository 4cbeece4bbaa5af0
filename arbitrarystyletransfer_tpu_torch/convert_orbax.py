"""Convert the JAX trainers' orbax checkpoints into the port's ``.pt`` files.

    python -m arbitrarystyletransfer_tpu_torch.convert_orbax SAVE_DIR [...]

For each ``SAVE_DIR`` (a JAX trainer's ``--save_dir``), writes ``ae.pt``,
``ast.pt`` and ``ast_dis.pt`` beside whichever of the orbax directories
``ae``, ``ast`` and ``ast_dis`` it holds, each through the port's atomic
``train/checkpoint.save_checkpoint``: the same params, batch_stats,
optimizer state and step, bit for bit (``train/orbax.read_orbax``).  It
needs ``tensorstore``, so run it where the JAX trainer ran, and copy the
``.pt`` files to the card's machine, which has none: there
``stylize --model SAVE_DIR/ast``, ``train --load --save_dir SAVE_DIR``,
``train --ae_model SAVE_DIR/ae`` and ``train_autoencoder --load`` read them
as they read the port's own.
"""

from __future__ import annotations

import argparse
import os
import sys

from .train.checkpoint import save_checkpoint
from .train.orbax import is_orbax_checkpoint, read_orbax

NAMES = ("ae", "ast", "ast_dis")


def convert(save_dir: str) -> list[str]:
    """The ``.pt`` files written for the orbax checkpoints in
    ``save_dir``."""
    written = []
    for name in NAMES:
        src = os.path.join(save_dir, name)
        if not is_orbax_checkpoint(src):
            continue
        tree = read_orbax(src)
        save_checkpoint(src + ".pt", tree, tree["opt_state"], tree["step"])
        written.append(src + ".pt")
    return written


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("save_dir", nargs="+",
                   help="a JAX trainer's save_dir (holding ae, ast or "
                        "ast_dis)")
    args = p.parse_args(argv)
    for save_dir in args.save_dir:
        written = convert(save_dir)
        if not written:
            p.error(f"{save_dir} holds no orbax checkpoint named "
                    f"{', '.join(NAMES)}")
        for path in written:
            print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
