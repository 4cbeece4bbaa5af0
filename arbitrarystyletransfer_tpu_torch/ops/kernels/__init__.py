"""Hand-written Hopper kernels of the port, each beside its plain twin.

``LAUNCHES`` counts, per kernel, the launches its wrapper made on a CUDA
tensor; a CPU tensor takes the plain twin and counts nothing.  A run resets
the counts with ``reset_launches()`` and reads them afterwards to show that
its path went through the kernels.
"""

LAUNCHES = {"expand_dw": 0, "adaattn_fwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
