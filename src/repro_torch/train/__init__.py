"""Training of the port: optimizers, int8 error-feedback compression, the
train / eval steps (see ``repro.train`` for the reference)."""
