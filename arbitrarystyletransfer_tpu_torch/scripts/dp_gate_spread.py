"""How far the data-parallel step lies from the one-process step, seed by
seed, beside the gate's yardsticks, on the card.

    python -m arbitrarystyletransfer_tpu_torch.scripts.dp_gate_spread \\
        [--seeds 5]

Run from the repository root (it uses ``chip_smoke.py``'s dp phase).  For
each seed it draws the weights (``chip_smoke.random_state``) and the
batches anew and runs the dp phase's three gate steps (the train, GAN and
autoencoder steps on 2 ranks against one process, ``chip_smoke.dp_phase``
with ``light``), holding none, and prints one JSON object: per step and
kind, the dp step's distance, its limit and their share.  Needs CUDA.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("dp_gate_spread: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as c

    from arbitrarystyletransfer_tpu_torch.ops.kernels import _build

    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for seed in range(1, args.seeds + 1):
        c.SEED = seed
        gen = torch.Generator(device=c.DEVICE).manual_seed(seed + 15)
        gates = c.dp_phase(gen, card, 0.0, light=True)
        print(json.dumps({"seed": seed, "gates": {
            step: {kind: {"distance": d, "limit": lim, "share": d / lim}
                   for kind, (d, lim) in kinds.items()}
            for step, kinds in gates.items()}}), flush=True)
        torch.cuda.empty_cache()
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
