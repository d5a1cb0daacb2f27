"""``chip_smoke.py``'s build checks, on short synthetic compiler texts.

Phase 2 of ``chip_smoke.py`` reads ptxas's ``-v`` lines and the SASS that
``cuobjdump -sass`` prints for each tensor-core instantiation of the flash
kernels: bf16 and fp16 for all three. Here those
readers run on texts written in the same formats, so that a spill in any
forward instantiation (head_dim 256 and its SPLIT form included) or in a
backward one at head_dim 64 or 256 (SPLIT included), a missing
instantiation of either io type, a missing product or a product of the
wrong operand type fails the check on the card. The instantiation counts
are tied to the sources: the head dims ``PT_FLASH_SWITCH_D`` instantiates,
the io types ``PT_FLASH_SWITCH_HOP_IO`` instantiates and the head_dim-256
forms ``fwd_heads``, ``dq_heads`` and ``dkv_heads`` launch.
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


# each kernel's parameters as nvcc mangles them: the outputs are of the
# template's io type (T0_)
ARGS = {"flash_fwd": "S3_S3_PT0_PfNS_6LayoutET1_fiii",
        "flash_bwd_dkv": "S3_S3_S3_PKfS5_PT0_S7_NS_6LayoutET1_fiii",
        "flash_bwd_dq": "S3_S3_S3_PKfS5_PT0_NS_6LayoutET1_fiii"}


def _entries(lib, ios=None):
    """Mangled names of every tensor-core instantiation of ``lib`` (of the
    io types ``ios``, by default all of ``cs.HOPPER_IO[lib]``), as nvcc
    names them: the io type is each kernel's second template argument."""
    kernel = KERNEL_TAGS[lib]
    names = []
    for io in ios or cs.HOPPER_IO[lib]:
        for mask, tag in MASK_TAGS.items():
            for d, split in ((32, 0), (64, 0), (128, 0), (256, 0), (256, 1)):
                names.append(f"_ZN8pt_flash{kernel}ILi{d}E{cs.IO_TAGS[io]}NS_"
                             f"{tag}ELb{split}EEEv14CUtensorMap_st{ARGS[lib]}")
    return names


def _pick(names, d, mask, split, io="bf16"):
    return next(n for n in names if cs.io_of(n) == io and
                f"ILi{d}E" in n and f"NS_{MASK_TAGS[mask]}ELb{split}" in n)


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
        # bf16 operands spell .F32.BF16; fp16 ones .F32 alone
        ty = ".F32.BF16" if cs.io_of(name) == "bf16" else ".F32"
        if "desc" not in drop:
            body.append(f"        /*0100*/                   HGMMA.64x64x16"
                        f"{ty} R24, gdesc[UR4], RZ, !UPT ;")
        if "regs" not in drop:
            shape = pv_shape if "ILi256E" in name else "64x64x16"
            body.append(f"        /*0200*/                   HGMMA.{shape}"
                        f"{ty} R24, R152, gdesc[UR8].tnspB, R24 ;")
        body.append("        /*0300*/                   EXIT ;")
        out.append("\n".join(body))
    return "\n".join(out) + "\n"


def _switch_dims():
    text = (CSRC / "flash_common.cuh").read_text()
    macro = text[text.index("#define PT_FLASH_SWITCH_D"):]
    macro = macro[:macro.index("default:")]
    return [int(d) for d in re.findall(r"case (\d+):", macro)]


def _switch_io():
    """The io types ``PT_FLASH_SWITCH_HOP_IO`` instantiates, by C type."""
    text = (CSRC / "flash_common.cuh").read_text()
    macro = text[text.index("#define PT_FLASH_SWITCH_HOP_IO"):]
    macro = macro[:macro.index("default:")]
    return re.findall(r"using T = (\w+);", macro)


def test_instantiation_counts_follow_the_sources():
    dims = _switch_dims()
    assert dims == [32, 64, 128]
    assert _switch_io() == ["__nv_bfloat16", "__half"]
    assert {io: tag[tag.index("__"):] for io, tag in cs.IO_TAGS.items()} == {
        "bf16": "__nv_bfloat16", "fp16": "__half"}
    masks = len(cs.MASKS)
    for lib, launch in (("flash_fwd", "fwd_wide_launch<T, Mask, "),
                        ("flash_bwd_dq", "dq_wide_launch<T, Mask, "),
                        ("flash_bwd_dkv", "dkv_wide_launch<T, Mask, ")):
        src = (CSRC / f"{lib}.cu").read_text()
        wide = set(re.findall(re.escape(launch) + r"(true|false)>", src))
        assert wide == {"true", "false"}, lib
        # fp16 reaches the tensor-core kernel where the source switches on
        # both io types, and only bf16 where it tests IO_BF16 alone
        both = "PT_FLASH_SWITCH_HOP_IO" in src
        assert both == ("IO_BF16" not in src), lib
        assert cs.HOPPER_IO[lib] == (("bf16", "fp16") if both else ("bf16",))
        assert cs.HOPPER_INSTANTIATIONS[lib] == (
            len(cs.HOPPER_IO[lib]) * masks * (len(dims) + len(wide)))
    assert cs.HOPPER_INSTANTIATIONS == {"flash_fwd": 30, "flash_bwd_dq": 30,
                                        "flash_bwd_dkv": 30}


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_spill_free_build_passes(lib):
    cs.check_spills(lib, _ptxas(_entries(lib)))


@pytest.mark.parametrize("io", ["bf16", "fp16"])
@pytest.mark.parametrize("d, split", [(256, 0), (256, 1), (64, 0), (32, 0)])
@pytest.mark.parametrize("mask", sorted(MASK_TAGS))
def test_a_spilling_forward_instantiation_fails(mask, d, split, io):
    names = _entries("flash_fwd")
    bad = _pick(names, d, mask, split, io)
    found = cs.hopper_spills(_ptxas(names, {bad: (944, 1016)}),
                             "flash_fwd_hopper")
    assert (bad, 944, 1016) in found and len(found) == 30
    with pytest.raises(RuntimeError, match="spills 944 / 1016"):
        cs.check_spills("flash_fwd", _ptxas(names, {bad: (944, 1016)}))


@pytest.mark.parametrize("lib", ["flash_bwd_dq", "flash_bwd_dkv"])
def test_backward_spills_are_read_at_head_dim_64(lib):
    names = _entries(lib)
    n_io = len(cs.HOPPER_IO[lib])
    at64 = [n for n in names if "ILi64E" in n]
    at128 = [n for n in names if "ILi128E" in n]
    assert len(cs.hopper_spills(_ptxas(names), cs.HOPPER_KERNELS[lib][0],
                                (64,))) == 3 * n_io
    assert len(cs.hopper_spills(_ptxas(names), cs.HOPPER_KERNELS[lib][0],
                                cs.SPILL_FREE[lib])) == 9 * n_io
    cs.check_spills(lib, _ptxas(names, {at128[0]: (8, 8)}))
    for bad in (at64[1], at64[-1]):  # bf16, and fp16 where it is built
        with pytest.raises(RuntimeError, match="spills"):
            cs.check_spills(lib, _ptxas(names, {bad: (8, 8)}))


@pytest.mark.parametrize("split", [0, 1])
@pytest.mark.parametrize("mask", sorted(MASK_TAGS))
@pytest.mark.parametrize("lib, io", [("flash_bwd_dq", "bf16"),
                                     ("flash_bwd_dq", "fp16"),
                                     ("flash_bwd_dkv", "bf16"),
                                     ("flash_bwd_dkv", "fp16")])
def test_a_spilling_wide_backward_instantiation_fails(lib, io, mask, split):
    names = _entries(lib)
    bad = _pick(names, 256, mask, split, io)
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


@pytest.mark.parametrize("lib", ["flash_fwd", "flash_bwd_dkv",
                                 "flash_bwd_dq"])
def test_a_build_without_fp16_instantiations_fails(lib):
    """All three libraries must hold fp16 tensor-core instantiations: a
    build with the bf16 ones alone (fp16 on an FMA kernel) fails the spill
    count and the SASS count; one fp16 instantiation missing fails the SASS
    count by io type."""
    bf16_only = _entries(lib, ("bf16",))
    with pytest.raises(RuntimeError, match="spill lines"):
        cs.check_spills(lib, _ptxas(bf16_only))
    with pytest.raises(RuntimeError, match="instantiations in the SASS"):
        cs.check_sass(lib, _sass(bf16_only))
    names = _entries(lib)
    one_short = [n for n in names if n != _pick(names, 64, "CausalMask", 0,
                                                "fp16")]
    with pytest.raises(RuntimeError, match="instantiations in the SASS"):
        cs.check_sass(lib, _sass(one_short + [_pick(names, 64, "CausalMask",
                                                    0, "bf16")]))


@pytest.mark.parametrize("lib", sorted(KERNEL_TAGS))
def test_sass_split_counts_each_instantiation(lib, capsys):
    names = _entries(lib)
    found = cs.sass_split(_sass(names), cs.HOPPER_KERNELS[lib][0])
    assert [f["name"] for f in found] == names
    assert all(f["desc"] == 1 and f["regs"] == 1 and f["tma"] == 1
               for f in found)
    assert [f["io"] for f in found] == [
        io for io in cs.HOPPER_IO[lib] for _ in range(15)]
    cs.check_sass(lib, _sass(names))
    assert capsys.readouterr().out.count("SASS ") == len(names)


def test_sass_split_reads_an_fp16_hgmma_line():
    """An fp16 instantiation's products as ``cuobjdump`` spells them
    (``.F32`` with no ``BF16``) count as products of its io type; bf16
    products in an fp16 instantiation, or fp16 ones in a bf16 one, fail."""
    _reads_an_fp16_hgmma_line("flash_fwd")


def test_sass_split_reads_an_fp16_dq_hgmma_line():
    """The same for an fp16 dQ instantiation, whose io type is its second
    template argument as the forward's is."""
    _reads_an_fp16_hgmma_line("flash_bwd_dq")


def _reads_an_fp16_hgmma_line(lib):
    kernel = cs.HOPPER_KERNELS[lib][0]
    name = _pick(_entries(lib), 64, "CausalMask", 0, "fp16")
    text = ("\n\t\tFunction : " + name + "\n"
            "        /*0090*/  UTMALDG.3D [UR8], [UR4] ;\n"
            "        /*0100*/  HGMMA.64x64x16.F32 R24, gdesc[UR4], RZ, !UPT, "
            "gsb0 ;\n"
            "        /*0200*/  HGMMA.64x64x16.F32 R24, R152, gdesc[UR8].tnspB, "
            "R24, gsb0 ;\n")
    (f,) = cs.sass_split(text, kernel)
    assert f["io"] == "fp16" and f["desc"] == 1 and f["regs"] == 1
    assert f["types"] == [".F32"]
    names = _entries(lib)
    good = _sass(names)
    cs.check_sass(lib, good)
    swapped = good.replace("HGMMA.64x64x16.F32 R24, gdesc",
                           "HGMMA.64x64x16.F32.BF16 R24, gdesc")
    with pytest.raises(RuntimeError, match="fp16 instantiation with HGMMA"):
        cs.check_sass(lib, swapped)
    only_f16 = good.replace(".F32.BF16", ".F32")
    with pytest.raises(RuntimeError, match="bf16 instantiation with HGMMA"):
        cs.check_sass(lib, only_f16)


def test_sass_split_reads_the_wide_pv_shape():
    names = _entries("flash_fwd")
    found = {f["name"]: f for f in cs.sass_split(_sass(names),
                                                 "flash_fwd_hopper")}
    wide = [n for n in names if "ILi256E" in n]
    assert len(wide) == 12  # bf16 and fp16, each SPLIT and not, 3 masks
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
    assert len(wide) == 6 * len(cs.HOPPER_IO[lib])
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
        (key,) = [k for k in cs.D256_SMEM if k.startswith(f"{lib} bf16")]
        assert cs.D256_SMEM[key] == want
    assert want <= 232448
    assert all(v <= 232448 for v in cs.D256_SMEM.values())
