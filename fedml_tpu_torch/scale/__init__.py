"""Serving-scale helpers (port of fedml_tpu/scale/; what the comm layer
and the async server need so far: ``serve.rss_bytes``, ``arrivals``, the
seeded arrival processes the connection swarm and the async scheduler
pace by, and ``registry``, the sharded client registry)."""
