"""Preemption safety: turn SIGTERM/SIGINT into a clean final checkpoint.

Cluster schedulers preempt with SIGTERM (and humans with Ctrl-C); a
handler that raises mid-chunk would tear the run state between the
device program and the host bookkeeping.  :class:`PreemptionGuard`
instead *latches* the first signal: the training loop keeps running to
its next boundary, notices ``guard.triggered``, drains the in-flight
async save, commits a final checkpoint and exits cleanly.  A second
signal falls through to the original handler (usually: die now) so a
wedged drain can still be killed.
"""

from __future__ import annotations

import signal
from typing import Optional, Tuple

__all__ = ["PreemptionGuard"]


class PreemptionGuard:
    """Context manager latching SIGTERM/SIGINT into a ``triggered`` flag.

    ::

        with PreemptionGuard() as guard:
            for r in range(rounds):
                train_one(r)
                if guard.triggered:
                    save_final_checkpoint()
                    break
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,
                                                   signal.SIGINT)):
        self.signals = tuple(signals)
        self.triggered = False
        self.signum: Optional[int] = None
        self._previous: dict = {}

    def _handle(self, signum, frame):
        if self.triggered:
            # second signal: the drain is taking too long — defer to the
            # original disposition (default SIGTERM/SIGINT terminate)
            prev = self._previous.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            signal.signal(signum, prev if prev is not None else signal.SIG_DFL)
            signal.raise_signal(signum)
            return
        self.triggered = True
        self.signum = signum

    def __enter__(self) -> "PreemptionGuard":
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        return None
