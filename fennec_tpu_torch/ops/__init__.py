"""Device compute in torch, and kernel K1 (ops/ssim_cuda.py)."""
