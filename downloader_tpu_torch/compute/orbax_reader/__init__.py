"""A reader of the JAX package's orbax checkpoints in numpy and the
standard library: no orbax, tensorstore or zstandard, so it runs where
the port serves the model.

- ``zstd.py``  — Zstandard decoding (RFC 8878)
- ``ocdbt.py`` — the OCDBT key-value store orbax keeps each item in
- ``zarr2.py`` — zarr v2 arrays over that store
- ``step.py``  — one step: ``read_step(step_dir) -> {"params", "opt_state"}``
"""
