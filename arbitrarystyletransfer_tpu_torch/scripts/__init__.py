"""Probe drivers of the port: the counterparts of the repository's
``scripts/probe_mega2.py`` and ``scripts/probe_vpu_rate.py``.

    python -m arbitrarystyletransfer_tpu_torch.scripts.probe_mega2
    python -m arbitrarystyletransfer_tpu_torch.scripts.probe_vpu_rate

Each keeps the JAX script's flags, defaults and JSON keys, runs on the card
(``--device cuda``, the default, raises without CUDA) and times the kernels
of ``ops/kernels/probes.py``.  ``--device cpu`` runs their plain twins once
and reports every time as null (not measured).
"""
