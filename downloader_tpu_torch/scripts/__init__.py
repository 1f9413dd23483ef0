"""Scripts of the port, run as ``python -m downloader_tpu_torch.scripts.<name>``."""
