"""Upscaler ops: layout, colorspace, the conv epilogue, the s2d head and
the quantize tail."""
