"""chunk_gap_ms: the device's wait between two chunks, in ms: from the end of
the last kernel of one chunk's replays to the start of the first kernel of
the next one's (the driver's batch stacking, host-to-device copy, metrics
copy and tau trace lie in it), averaged over the traced gaps.  Read from the
device trace; moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""


def read(view):
    if view.cell.get("device") != "cuda":
        return None
    ends, starts = {}, {}
    for k in view.graph_kernels():
        c = k.graph_chunk
        ends[c] = max(ends.get(c, k.end), k.end)
        starts[c] = min(starts.get(c, k.start), k.start)
    gaps = [starts[c + 1] - ends[c] for c in sorted(ends) if c + 1 in starts]
    return sum(gaps) / len(gaps) * 1e-6 if gaps else None
