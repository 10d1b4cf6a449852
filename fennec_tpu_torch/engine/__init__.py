"""Compression engines: the SSIM-guided JPEG search and the PNG optimizer."""
