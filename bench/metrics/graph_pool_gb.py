"""graph_pool_gb: the device memory the captured round's graph pool holds,
in GB, as the program counts it (``ScanRound.stats["pool_bytes"]``).
Moves peak_gb."""


def read(view):
    pool = view.stats.get("pool_bytes")
    return None if pool is None else pool / 1e9
