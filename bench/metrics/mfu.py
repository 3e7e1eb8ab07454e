"""mfu: the model FLOPs of the measured window over the window's length times
the configuration's peak, in %: rounds_per_s x the configuration's FLOPs a
round (the harness's arithmetic from shapes: 6 x MACs x images for the CNN,
6 N D for the decoder) / the peak.  Read by the host clock over the window;
moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""


def read(view):
    if view.cell.get("device") != "cuda":
        return None
    c = view.cell
    return 100.0 * float(c["rounds_per_s"]) * float(c["flops_per_round"]) / float(c["peak_flops"])
