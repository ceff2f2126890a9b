"""Core substrate of the port: tensor trees, the host archive, HyperOffload
and HyperShard (``layout``, ``hypershard``, ``meshctx``,
``ring_attention``)."""
