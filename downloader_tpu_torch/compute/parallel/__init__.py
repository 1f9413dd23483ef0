"""Host<->device transfer queue and hop billing (single card so far)."""
