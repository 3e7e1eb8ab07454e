"""The benchmark's tests: ``python -m pytest bench/tests`` from the root of
the repository.  The harness's library, the port under ``src/`` and the
benchmark's own directories are put on the path; the tests marked ``cuda``
decide inside a fixture whether a card is there."""

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    import torch

    # a few threads a process: the tests run side by side
    torch.set_num_threads(4)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def registry():
    from benchlib.registry import Registry

    return Registry()
