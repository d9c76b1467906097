"""Serving-scale helpers (port of fedml_tpu/scale/; only what the comm
layer needs so far: ``serve.rss_bytes``)."""
