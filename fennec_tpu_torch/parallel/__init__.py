"""Batched device programs (counterpart of fennec_tpu/parallel)."""
