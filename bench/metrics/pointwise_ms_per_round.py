"""pointwise_ms_per_round: device ms a round in every kernel of the replayed
rounds that is neither a matrix product or convolution (the patterns of
``matmul_ms_per_round``) nor kernel 1, the aggregation: the normalisations,
activations, copies of the client loop, the f32 deltas into the update
stack and the optimizers' passes.  Read from the device trace; moves rounds_per_s (as
``<name>.lm``, rounds_per_s.lm in the decoder cells)."""

import importlib.util
import pathlib

_spec = importlib.util.spec_from_file_location(
    "bench_metric_matmul_patterns", pathlib.Path(__file__).with_name("matmul_ms_per_round.py"))
_matmul = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_matmul)

AGGREGATION = "fused_aggregate_kernel"


def read(view):
    ks = view.graph_kernels()
    if not ks or view.rounds <= 0:
        return None
    ns = sum(k.end - k.start for k in ks
             if AGGREGATION not in k.name and not _matmul.is_matmul(k.name))
    return ns * 1e-6 / view.rounds
