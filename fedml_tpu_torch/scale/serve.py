"""The serving layer's process probes (port of fedml_tpu/scale/serve.py).

Only ``rss_bytes`` is here: the reactor's memory-based load shedding
reads it (``comm/reactor.py``).  The rest of ``serve`` (the lane
machinery of the async serving path) comes with slice 4 of the port.
"""
from __future__ import annotations


def rss_bytes() -> int:
    """Resident set size of this process (0 where /proc is absent)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0
