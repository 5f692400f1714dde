"""The benchmark of gubernator_tpu_torch: ``python3 portbench/run.py``."""
