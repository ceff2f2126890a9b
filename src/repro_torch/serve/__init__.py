"""HyperServe of the port: paged KV pool, continuous-batching scheduler,
engine loop and the ``HyperServe`` front door."""
