"""Measurement tools for darwin_tpu_torch on a CUDA card."""
