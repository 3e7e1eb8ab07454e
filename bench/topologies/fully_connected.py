"""fully_connected: every pair of clients linked, each D2D link up with
probability ``p_c`` a round, the pairs' reciprocity ``rho``; client i's
uplink up with probability ``p_up[i]`` (one number: the same for all ``n``)."""

from __future__ import annotations

import numpy as np

from benchlib import links as _links


def links(topology: dict) -> _links.Links:
    p_up = topology["p_up"]
    if np.ndim(p_up) == 0:
        p_up = [float(p_up)] * int(topology["n"])
    return _links.fully_connected(p_up, topology["p_c"], topology["rho"])
