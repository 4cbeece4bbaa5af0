"""Hand-written Hopper kernels of the port, each beside its plain twin.

``LAUNCHES`` counts, per kernel, the calls its wrapper launched on a CUDA
tensor (one per call, though the flat kernels make two CUDA launches each);
a CPU tensor takes the plain twin and counts nothing.  A run resets
the counts with ``reset_launches()`` and reads them afterwards to show that
its path went through the kernels.
"""

LAUNCHES = {"expand_dw": 0, "adaattn_fwd": 0, "flat_block": 0,
            "flat_s2_block": 0, "adaattn_dq": 0, "adaattn_dkv": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
