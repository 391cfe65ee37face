"""The benchmark of ``sprsolve_tpu_torch`` (see ``harness.py``)."""
