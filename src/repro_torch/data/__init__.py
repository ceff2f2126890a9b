"""Synthetic training data of the port (the reference's ``repro.data``)."""
