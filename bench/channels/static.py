"""static: the paper's i.i.d. links (Sec. II-B).  Every round draws its taus
anew from the topology's fixed law, each round's draw a function of the seed
and the round alone (:class:`benchlib.links.TauStream`), so that both sides
are given the same taus."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from benchlib import links as _links


def program_channel(links: _links.Links, seed: int) -> _links.TauStream:
    """What the port's trainer takes as ``channel``: the stream of taus, and
    the program's own link type built from the same arrays."""
    from repro_torch.core.connectivity import LinkModel

    return _links.TauStream(links, seed, model=LinkModel(links.p, links.P, links.E))


def reference_taus(links: _links.Links, seed: int,
                   rounds: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``(tau_up, tau_dd)`` of rounds ``0 .. rounds - 1``."""
    stream = _links.TauStream(links, seed)
    return [stream.tau_for_round(r) for r in range(rounds)]
