"""The kernel probes (tools/torch_*_probe.py) as far as the CPU shows: each
patch still finds its anchors in the port's CUDA sources as they are, and
the shared helpers read ptxas's report and refuse a missing anchor. The
builds and the timings run only on the card."""

import importlib
import sys
from pathlib import Path

import pytest

from realpdebench_tpu_torch.ops import kernels

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tools():
    for p in (str(ROOT), str(ROOT / "tools")):
        if p not in sys.path:
            sys.path.insert(0, p)
    return lambda name: importlib.import_module(name)


@pytest.mark.parametrize("probe, source", [("torch_k3b_probe", "fno_tail.cu"),
                                           ("torch_gk_probe", "galerkin_scores.cu"),
                                           ("torch_ta_probe", "temporal_attention.cu")])
def test_source_patches_find_their_anchors(tools, probe, source):
    text = (kernels.CSRC / source).read_text()
    mma = (kernels.CSRC / "mma.cuh").read_text()
    mma_patches = getattr(tools(probe), "MMA_PATCHES", {})
    for name, (patch, *_) in tools(probe).VARIANTS.items():
        if patch is not None:   # None: the parent's source, as it is
            changed = patch(text) != text or (name in mma_patches
                                              and mma_patches[name](mma) != mma)
            assert changed or "as_is" in name, name


def test_tf32_probe_patches_find_their_anchors(tools):
    probe = tools("torch_tf32_probe")
    for name, (source, hpatch, spatch, _) in probe.VARIANTS.items():
        header = (kernels.CSRC / probe.HEADER[source]).read_text()
        text = (kernels.CSRC / source).read_text()
        changed = spatch(text) != text or (hpatch is not None and hpatch(header) != header)
        mma = (kernels.CSRC / "mma.cuh").read_text()
        changed = changed or (name in probe.MMA_PATCHES and probe.MMA_PATCHES[name](mma) != mma)
        assert changed or "as_is" in name, name


@pytest.mark.parametrize("parts", [("mma",), ("ldmatrix",), ("mma", "ldmatrix"), ("stats",),
                                   ("store",)])
def test_k2_probe_patches_find_their_anchors(tools, parts):
    probe = tools("torch_k2_probe")
    text = (kernels.CSRC / "fno_k2.cu").read_text()
    assert probe.with_clocks(text) != text
    assert probe.cut(text, *parts) != text


def test_registers_reads_the_entry_named(tools):
    report = (
        "ptxas info    : Compiling entry function '_Z3fooILi64EEvPKf' for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z14k2_tf32_kernelILi64ELi2EEvPKf' for 'sm_90a'\n"
        "    84 bytes stack frame, 84 bytes spill stores, 84 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'\n"
        "ptxas info    : Used 12 registers\n")
    got = tools("torch_probe_common").registers(report, "k2_tf32_kernelILi64E")
    assert got == {"registers": 96,
                   "spill": "84 bytes stack frame, 84 bytes spill stores, 84 bytes spill loads"}


def test_sub_refuses_a_missing_or_repeated_anchor(tools):
    sub = tools("torch_probe_common").sub
    assert sub("a b a", "b", "c") == "a c a"
    assert sub("a b a", "a", "c", count=2) == "c b c"
    for old in ("a", "z"):
        with pytest.raises(SystemExit, match="of the anchor"):
            sub("a b a", old, "c")
