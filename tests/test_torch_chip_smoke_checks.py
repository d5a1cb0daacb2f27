"""``chip_smoke.py``'s build checks, on short synthetic compiler texts.

Phase 2 of ``chip_smoke.py`` reads ptxas's ``-v`` lines and the SASS that
``cuobjdump -sass`` prints for each bf16 tensor-core instantiation of the
flash kernels. Here those readers run on texts written in the same formats,
so that a spill in any forward instantiation (head_dim 256 and its SPLIT
form included) or in a backward one at head_dim 64 or 256 (SPLIT
included), a missing instantiation or a missing product fails the check
on the card. The instantiation counts are tied to the sources: the head
dims ``PT_FLASH_SWITCH_D`` instantiates and the head_dim-256 forms
``fwd_heads``, ``dq_heads`` and ``dkv_heads`` launch.
"""
import re
from pathlib import Path

import pytest

import chip_smoke as cs

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "paddle_tpu_torch" / "csrc"
MASK_TAGS = {"CausalMask": "10CausalMask", "SegmentMask": "11SegmentMask",
             "StartEndMask": "12StartEndMask"}
KERNEL_TAGS = {"flash_fwd": "16flash_fwd_hopper",
               "flash_bwd_dq": "19flash_bwd_dq_hopper",
               "flash_bwd_dkv": "20flash_bwd_dkv_hopper"}


def _entries(lib):
    """Mangled names of every bf16 tensor-core instantiation of ``lib``,
    as nvcc names them."""
    kernel = KERNEL_TAGS[lib]
    names = []
    args = ("S2_S2_P13__nv_bfloat16Pf" if lib == "flash_fwd"
            else "S2_S2_S2_PKfS4_P13__nv_bfloat16")
    for mask, tag in MASK_TAGS.items():
        for d, split in ((32, 0), (64, 0), (128, 0), (256, 0), (256, 1)):
            names.append(f"_ZN8pt_flash{kernel}ILi{d}ENS_{tag}ELb{split}"
                         f"EEEv14CUtensorMap_st{args}")
    return names


def _ptxas(names, spills=None):
    """ptxas ``-v`` lines (as ``_build._ptxas_lines`` keeps them) for
    ``names``; ``spills`` maps a name to its (store, load) spill bytes."""
    spills = spills or {}
    lines = []
    for name in names:
        st, ld = spills.get(name, (0, 0))
        lines += [f"ptxas info    : Compiling entry function '{name}' for "
                  f"'sm_90a'",
                  f"{st} bytes stack frame, {st} bytes spill stores, "
                  f"{ld} bytes spill loads",
                  "ptxas info    : Used 210 registers, used 1 barriers"]
    return lines


def _sass(names, pv_shape="64x256x16", drop=()):
    """A ``cuobjdump -sass`` text for ``names``: per function TMA loads,
    products from descriptors and P V products with A from registers
    (the transpose bit); ``drop`` names instructions left out."""
    out = ["\n\tcode for sm_90a"]
    for name in names:
        body = [f"\t\tFunction : {name}",
                '\t.headerflags\t@"EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"']
        if "UTMALDG" not in drop:
            body.append("        /*0090*/                   UTMALDG.3D [UR8], "
                        "[UR4] ;")
        if "desc" not in drop:
            body.append("        /*0100*/                   HGMMA.64x64x16."
                        "F32.BF16 R24, gdesc[UR4], RZ, !UPT ;")
        if "regs" not in drop:
            shape = pv_shape if "ILi256E" in name else "64x64x16"
            body.append(f"        /*0200*/                   HGMMA.{shape}."
                        f"F32.BF16 R24, R152, gdesc[UR8].tnspB, R24 ;")
        body.append("        /*0300*/                   EXIT ;")
        out.append("\n".join(body))
    return "\n".join(out) + "\n"


def _switch_dims():
    text = (CSRC / "flash_common.cuh").read_text()
    macro = text[text.index("#define PT_FLASH_SWITCH_D"):]
    macro = macro[:macro.index("default:")]
    return [int(d) for d in re.findall(r"case (\d+):", macro)]


def test_instantiation_counts_follow_the_sources():
    dims = _switch_dims()
    assert dims == [32, 64, 128]
    masks = len(cs.MASKS)
    for lib, launch in (("flash_fwd", "fwd_wide_launch"),
                        ("flash_bwd_dq", "dq_wide_launch"),
                        ("flash_bwd_dkv", "dkv_wide_launch")):
        src = (CSRC / f"{lib}.cu").read_text()
        wide = set(re.findall(launch + r"<Mask, (true|false)>", src))
        assert wide == {"true", "false"}, lib
        assert cs.HOPPER_INSTANTIATIONS[lib] == masks * (len(dims) + len(wide))
    assert set(cs.HOPPER_INSTANTIATIONS.values()) == {15}


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_spill_free_build_passes(lib):
    cs.check_spills(lib, _ptxas(_entries(lib)))


@pytest.mark.parametrize("d, split", [(256, 0), (256, 1), (64, 0), (32, 0)])
@pytest.mark.parametrize("mask", sorted(MASK_TAGS))
def test_a_spilling_forward_instantiation_fails(mask, d, split):
    names = _entries("flash_fwd")
    bad = next(n for n in names if f"ILi{d}ENS_{MASK_TAGS[mask]}ELb{split}"
               in n)
    found = cs.hopper_spills(_ptxas(names, {bad: (944, 1016)}),
                             "flash_fwd_hopper")
    assert (bad, 944, 1016) in found and len(found) == 15
    with pytest.raises(RuntimeError, match="spills 944 / 1016"):
        cs.check_spills("flash_fwd", _ptxas(names, {bad: (944, 1016)}))


@pytest.mark.parametrize("lib", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_spills_are_read_at_head_dim_64(lib):
    names = _entries(lib)
    at64 = [n for n in names if "ILi64E" in n]
    at128 = [n for n in names if "ILi128E" in n]
    assert len(cs.hopper_spills(_ptxas(names), cs.HOPPER_KERNELS[lib][0],
                                (64,))) == 3
    assert len(cs.hopper_spills(_ptxas(names), cs.HOPPER_KERNELS[lib][0],
                                cs.SPILL_FREE[lib])) == 9
    cs.check_spills(lib, _ptxas(names, {at128[0]: (8, 8)}))
    with pytest.raises(RuntimeError, match="spills"):
        cs.check_spills(lib, _ptxas(names, {at64[1]: (8, 8)}))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("mask", sorted(MASK_TAGS))
@pytest.mark.parametrize("lib", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_a_spilling_wide_backward_instantiation_fails(lib, mask, split):
    names = _entries(lib)
    bad = next(n for n in names if f"ILi256ENS_{MASK_TAGS[mask]}ELb{split}"
               in n)
    found = cs.hopper_spills(_ptxas(names, {bad: (168, 172)}),
                             cs.HOPPER_KERNELS[lib][0], cs.SPILL_FREE[lib])
    assert (bad, 168, 172) in found
    with pytest.raises(RuntimeError, match="spills 168 / 172"):
        cs.check_spills(lib, _ptxas(names, {bad: (168, 172)}))


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_a_missing_instantiation_fails_the_spill_count(lib):
    names = _entries(lib)
    names = [n for n in names if "ILi64E" not in n or "Causal" not in n]
    with pytest.raises(RuntimeError, match="spill lines"):
        cs.check_spills(lib, _ptxas(names))


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_sass_split_counts_each_instantiation(lib, capsys):
    names = _entries(lib)
    found = cs.sass_split(_sass(names), cs.HOPPER_KERNELS[lib][0])
    assert [f["name"] for f in found] == names
    assert all(f["desc"] == 1 and f["regs"] == 1 and f["tma"] == 1
               for f in found)
    cs.check_sass(lib, _sass(names))
    assert capsys.readouterr().out.count("SASS ") == len(names)


def test_sass_split_reads_the_wide_pv_shape():
    names = _entries("flash_fwd")
    found = {f["name"]: f for f in cs.sass_split(_sass(names),
                                                 "flash_fwd_hopper")}
    wide = [n for n in names if "ILi256E" in n]
    assert len(wide) == 6
    for n in wide:
        assert found[n]["regs_shapes"] == ["64x256x16"]
        assert found[n]["desc_shapes"] == ["64x64x16"]
    cs.check_sass("flash_fwd", _sass(names, pv_shape="64x128x16"))


@pytest.mark.parametrize("lib", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_sass_split_reads_the_wide_backward_product_shapes(lib):
    names = _entries(lib)
    found = {f["name"]: f for f in cs.sass_split(
        _sass(names), cs.HOPPER_KERNELS[lib][0])}
    wide = [n for n in names if "ILi256E" in n]
    assert len(wide) == 6
    for n in wide:
        assert found[n]["regs_shapes"] == ["64x256x16"]
    cs.check_sass(lib, _sass(names))
    with pytest.raises(RuntimeError, match="P V shapes"):
        cs.check_sass(lib, _sass(names, pv_shape="64x64x16"))


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_a_missing_sass_instantiation_fails(lib):
    names = _entries(lib)[1:]
    with pytest.raises(RuntimeError, match="instantiations in the SASS"):
        cs.check_sass(lib, _sass(names))


@pytest.mark.parametrize("drop", ["UTMALDG", "desc", "regs"])
def test_sass_without_a_product_or_a_tma_load_fails(drop):
    names = _entries("flash_fwd")
    with pytest.raises(RuntimeError, match="HGMMA"):
        cs.check_sass("flash_fwd", _sass(names, drop=(drop,)))


def test_a_wide_pv_of_another_shape_fails():
    with pytest.raises(RuntimeError, match="P V shapes"):
        cs.check_sass("flash_fwd", _sass(_entries("flash_fwd"),
                                         pv_shape="64x64x16"))


def test_wide_forward_shared_memory_fits_a_block():
    common = (CSRC / "flash_common.cuh").read_text()
    bufs = int(re.search(r"BUFS = (\d+);", common).group(1))
    tile = 64 * 256 * 2
    want = 1024 + bufs * tile + 8 * (1 + 2 * bufs) + 32 + 4 * 256
    for lib in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert cs.D256_SMEM[f"{lib} bf16"] == want
    assert want <= 232448
    assert all(v <= 232448 for v in cs.D256_SMEM.values())
