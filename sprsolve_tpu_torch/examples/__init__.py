"""Runnable examples of the port: ``python -m sprsolve_tpu_torch.examples.demo``,
``... .tour`` and ``... .eigen_tour``, each with ``--device`` (default: the
CUDA device; ``--device cpu`` runs on the CPU)."""
