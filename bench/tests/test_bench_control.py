"""The control: the plain reference put in the program's place and computed
one precision below the configuration's (bf16 for the f32 CNN, fp8 for the
bf16 decoder).  Here at the rehearsal sizes on the CPU, where it has to
read at least three times what the port does; on the card, marked
``cuda``, at the cell's own size, where the cell's limits have to call it
incorrect."""

import pytest

import control
from benchlib import driver

WORKLOADS = ["resnet20.fig2b.k4", "olmo1b.seq64.k2"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_above_the_port(registry, workload):
    seed = 2**31 + 3
    ctl = control.readings(registry, workload, seed, rehearse=True)["control"]
    port = driver.run_cell(registry, workload, seed=seed, seconds=0.0, trace=False, t_start=0.0,
                           rehearse=True)["checks"]
    assert any(ctl[k] >= 3 * port[k]["value"] for k in port), (ctl, port)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["resnet20.fig2b.k4", "olmo1b.seq64.k2", "olmo1b.seq1024.k2"])
def test_control_fails_at_the_cells_size(registry, cuda_device, workload):
    out = control.readings(registry, workload, 2**31 + 11)
    assert not out["control"]["correct"], out
    assert not out["half_batch"]["correct"], out
