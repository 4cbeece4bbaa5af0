"""How far the autoencoder's float32 loss lies from float64, batch by batch,
for the JAX package and for the port, on the batches of ``chip_smoke.py``'s
lifecycle phase: the yardstick of its ``AE_LOSS_TOL``.

    python tests/torch_ae_loss_spread.py [--batches 8] [--size 256] \\
        [--batch 16]

Run from the repository root on the CPU (~10 min at the phase's size).
Writes the phase's synthetic PNGs (``write_images``), reads them through
the port's content loader as the phase does (one thread, the seed's file
order), loads the phase's weights (``ae_state(random_state(...))``, the
parity tests' redraw) and the trainers' seeded random VGG, and prints one
JSON object per batch: the loss of one train-mode forward in float32 and
its relative distance to float64, for JAX (``jnp.float32`` rebound to
float64 while the float64 loss traces, as ``test_torch_train_step.py``
does) and for the port (float64 copies of its modules, as the phase's
``ae_loss_f64``), and the two float64 losses' distance to each other.
Beside them the port's float32 loss over ``dp_orders``' row orders of the
batch, its largest distance to float64 (``port_orders``: the yardstick of
the phase's gate).  The last line gives the worst of each over the
batches.
"""

import argparse
import json
import os
import sys

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [TESTS, os.path.dirname(TESTS)]

import conftest  # noqa: E402,F401  (the CPU platform)
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from test_torch_ae_gate import (  # noqa: E402
    jax_losses,
    lifecycle_batches,
    order_spread,
    phase_weights,
    port_loss,
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--size", type=int, default=c.LIFE_AE_SIZE)
    ap.add_argument("--batch", type=int, default=c.LIFE_AE_BATCH)
    args = ap.parse_args(argv)

    batches = lifecycle_batches(args.batches, args.size, args.batch)
    state, variables, vgg_params = phase_weights()
    j32, j64 = (jax_losses(variables, vgg_params, batches, f64)
                for f64 in (False, True))
    worst = {}
    for i, batch in enumerate(batches):
        p32, p64 = (port_loss(state, vgg_params, batch, dt)
                    for dt in (torch.float32, torch.float64))
        rel = {"jax": abs(j32[i] - j64[i]) / abs(j64[i]),
               "port": abs(p32 - p64) / abs(p64),
               "port_orders": order_spread(state, vgg_params, batch, p64)}
        worst = {k: max(worst.get(k, 0.0), v) for k, v in rel.items()}
        print(json.dumps({"batch": i + 1,
                          "f32": {"jax": j32[i], "port": p32},
                          "relative_to_f64": rel,
                          "f64_jax_vs_port": abs(j64[i] - p64) / abs(j64[i])}),
              flush=True)
    print(json.dumps({"worst": worst, "size": args.size,
                      "batch": args.batch, "batches": args.batches}))


if __name__ == "__main__":
    main()
