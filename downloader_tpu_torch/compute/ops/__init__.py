"""Upscaler ops: layout, colorspace, the s2d head and the quantize tail."""
