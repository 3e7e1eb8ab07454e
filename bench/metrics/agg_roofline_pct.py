"""agg_roofline_pct: kernel 1's (``fused_aggregate_kernel``) share of its
roofline, in %: the least time the card could take for one launch over its
mean traced time.  The least time is the larger of its bytes over the
memory's rate and its operations over the f32 rate:

    bytes = 8 n^2 (A, tau_dd) + 4 n (tau_up) + 4 n d (the f32 stack) + 4 d (out)
    flops = 2 n d

at 3.35 TB/s and 67 TFLOP/s (H100 SXM).  Moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""

from benchlib import hw

KERNEL = "fused_aggregate_kernel"


def least_seconds(n: int, d: int) -> float:
    bytes_ = 8 * n * n + 4 * n + 4 * n * d + 4 * d
    return max(bytes_ / hw.HBM_BYTES_PER_S, 2 * n * d / hw.peak_flops("f32"))


def read(view):
    times = [k.end - k.start for k in view.kernels if KERNEL in k.name]
    if not times:
        return None
    mean_s = sum(times) / len(times) * 1e-9
    return 100.0 * least_seconds(int(view.cell["n_clients"]), int(view.cell["d"])) / mean_s
