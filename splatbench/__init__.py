"""The benchmark of splat_tpu_torch: ``run.py`` runs one cell once."""
