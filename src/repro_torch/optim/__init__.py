"""Optimizers of the port (the reference's ``repro.optim``)."""
