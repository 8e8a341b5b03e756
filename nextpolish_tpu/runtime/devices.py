"""The local devices the engines spread independent work over.

Task 1 round-robins contig groups and task 5 round-robins window groups
over these devices (the reference farms contig blocks across jobs,
source/nextPolish:93-117).  CPU runs keep one device, because virtual CPU
devices share the same cores, unless NPT_MULTIDEV=1 (the multi-device
equality tests).  Callers that need another set pass their own list to
the engine (score_chain_pipeline, CnsBatcher).
"""
from __future__ import annotations

import os


def compute_devices() -> list:
    import jax

    devices = jax.devices()
    if jax.default_backend() == "cpu" and \
            os.environ.get("NPT_MULTIDEV") != "1":
        return devices[:1]
    return devices
