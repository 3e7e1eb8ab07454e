"""CPU tests of the measures that hold kernel 11 on the card: the relative-L2
readings of ``chip_smoke.py`` and the hi-only copies of
``tools/ssd_split_probe.py`` that set their limit; and of the candidate
copies of kernel 6 that ``tools/dequant_probe.py`` times."""

from __future__ import annotations

import pathlib
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import dequant_probe  # noqa: E402
import ssd_split_probe as probe  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"


@pytest.mark.parametrize("T,chunk", [(96, 32), (100, 32), (64, 64)])
def test_ssd_rel_l2_reads_the_worst_chunk_and_slice(T, chunk):
    g = torch.Generator().manual_seed(0)
    want = torch.randn(3, T, 8, generator=g)
    assert cs.ssd_rel_l2(want.clone(), want, chunk) == (0.0, 0.0)
    got = want.clone()
    got[1, chunk:2 * chunk] *= 1.01  # one chunk of slice 1 off by 1% (a tail chunk at T=64)
    r_chunk, r_slice = cs.ssd_rel_l2(got, want, chunk)
    assert r_chunk == pytest.approx(0.01, rel=1e-4) if T > chunk else r_chunk == 0.0
    part = want[1, chunk:2 * chunk].pow(2).sum() / want[1].pow(2).sum()
    assert r_slice == pytest.approx(0.01 * float(part.sqrt()), rel=1e-4)


def test_ssd_held_holds_both_limits():
    want = torch.ones(2, 64, 4)
    assert "worst chunk relative L2 0.000e+00" in cs.ssd_held(want, want, 16, "x")
    got = want.clone()
    got[0] *= 1 + 2 * cs.SSD_SLICE_TOL  # every chunk of slice 0: past the slice limit only
    with pytest.raises(RuntimeError, match="a slice is"):
        cs.ssd_held(got, want, 16, "x")
    got = want.clone()
    got[0, :16] *= 1 + 2 * cs.SSD_CHUNK_TOL
    with pytest.raises(RuntimeError, match="a chunk is"):
        cs.ssd_held(got, want, 16, "x")


@pytest.mark.parametrize("cut", sorted(probe.CUTS))
def test_ssd_split_probe_cuts_one_split_of_the_kernel(tmp_path, cut):
    source = (CSRC / "ssd_scan.cu").read_text()
    src = probe.copy_with_cut(tmp_path, cut)
    edited = (src / "repro_torch" / "kernels" / "csrc" / "ssd_scan.cu").read_text()
    calls = source.count(probe.CUTS[cut])
    assert calls >= 1
    assert edited.count("split2_hi(") == calls + 1  # its definition and the cut calls
    assert edited.replace(probe.HI_ONLY, "").replace("split2_hi(", "split2(") == source
    for other in set(probe.CUTS) - {cut}:
        assert edited.count(probe.CUTS[other]) == source.count(probe.CUTS[other])


@pytest.mark.parametrize("label", sorted(dequant_probe.CANDIDATES))
def test_dequant_probe_copies_differ_from_the_source_by_their_edits_only(tmp_path, label):
    source = (CSRC / "fused_aggregate.cu").read_text()
    src = dequant_probe.copy_with_edits(tmp_path, label)
    edited = (src / "repro_torch" / "kernels" / "csrc" / "fused_aggregate.cu").read_text()
    for old, new in dequant_probe.CANDIDATES[label]:
        assert source.count(old) == 1 and edited.count(new) >= 1
        edited = edited.replace(new, old)
    assert edited == source
    for other in ("common.cuh", "relay_block.cu", "fused_memory.cu"):
        assert (src / "repro_torch" / "kernels" / "csrc" / other).read_text() == \
            (CSRC / other).read_text()


def test_mix_and_ssd_byte_counts():
    assert cs.mix_bytes(1, 16, 2**20, 1) == 4 * 16 * 16 + 8 * 16 * 2**20
    assert cs.mix_bytes(2, 5, cs.D_FULL, 2) == 8 * 10 * 5 + 8 * 10 * cs.D_FULL
    BH, T, Dk, Dv = cs.SSD_PREFILL_SHAPE
    assert cs.ssd_bytes(BH, T, Dk, Dv) == 2 * BH * T * (2 * Dk + 2 * Dv) + 4 * BH * T
