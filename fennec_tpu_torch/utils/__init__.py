"""Utilities: stage timing, device profiling hooks, debug checks
(counterpart of fennec_tpu/utils)."""

from .profiling import StageTimer, device_trace, nan_check  # noqa: F401
