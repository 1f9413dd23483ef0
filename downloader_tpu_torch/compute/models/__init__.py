"""The upscaler model."""
