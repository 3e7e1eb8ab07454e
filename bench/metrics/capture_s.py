"""capture_s: the chunked engine's seconds to build its captured round:
the eager warm-up round, the capture and the graph's instantiation, as the
program counts them (``ScanRound.stats``).  Moves setup_s."""


def read(view):
    s = view.stats
    if not all(k in s for k in ("warmup_s", "capture_s", "instantiate_s")):
        return None
    return float(s["warmup_s"]) + float(s["capture_s"]) + float(s["instantiate_s"])
