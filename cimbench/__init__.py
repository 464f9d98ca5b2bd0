"""Benchmark of the CIM serving path of repro_torch on one CUDA card (see run.py)."""
