"""Plain float32 references the benchmark judges the program against.

Nothing here imports the program, JAX or the JAX package: the
references read the benchmark's own inputs and weights and work out
again whatever the program derives from them (colorspace, crops,
training steps)."""
