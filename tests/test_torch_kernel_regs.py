"""The register and SASS report of ``read_tpu_torch.kernel_regs`` on the
CPU: its parsers read ``ptxas -v`` and ``cuobjdump -sass`` output as the
CUDA toolkit prints it (canned here: the toolkit exists only on the GPU
machine), and a kernel whose code is the same under a new name hashes
the same."""

from read_tpu_torch import kernel_regs as KR

PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN3gcw12wgmma_kernelILi128ELb1ELb0ELi0EEEvNS_4ArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN3gcw12wgmma_kernelILi128ELb1ELb0ELi0EEEvNS_4ArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 153 registers, used 1 barriers, 600 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4spillv' for 'sm_90a'
ptxas info    : Function properties for _Z4spillv
    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, 352 bytes cmem[0]
"""


def _sass(name, body):
    return (f"\n\tcode for sm_90a\n\t\tFunction : {name}\n"
            "\t.headerflags\t@\"EF_CUDA_SM90\"\n" + body)


def test_parse_ptxas_reads_registers_and_spills():
    got = KR.parse_ptxas(PTXAS)
    assert got == {
        "_ZN3gcw12wgmma_kernelILi128ELb1ELb0ELi0EEEvNS_4ArgsE":
            {"registers": 153, "spill_stores": 0, "spill_loads": 0},
        "_Z4spillv": {"registers": 255, "spill_stores": 12,
                      "spill_loads": 16}}


def test_parse_sass_hashes_bodies_without_names():
    body = ("        /*0000*/                   LDC R1, c[0x0][0x28] ;\n"
            "        /*0010*/                   EXIT ;\n")
    old = KR.parse_sass(_sass("_Z1av", body) + _sass(
        "_Z1bv", "        /*0000*/                   EXIT ;\n"))
    new = KR.parse_sass(_sass("_Z1av_renamed", body.replace(";", "   ;")))
    assert set(old) == {"_Z1av", "_Z1bv"}
    assert new["_Z1av_renamed"] == old["_Z1av"] != old["_Z1bv"]


def test_verdict_allows_only_the_named_kernels_to_change():
    """Every kernel of the other tree needs its SASS here unless its
    demangled name matches ``allow_changed``; a spill anywhere here
    fails too."""
    pretty = {"a_old": "f32<1>", "b_old": "bf16<1>", "a": "f32_new<1>",
              "b": "bf16<1>"}
    other = {"lib": {"a_old": {"sass": "x", "registers": 9},
                     "b_old": {"sass": "y", "registers": 8}}}
    mine = {"lib": {"a": {"sass": "z", "spill_stores": 0,
                          "spill_loads": 0},
                    "b": {"sass": "y", "spill_stores": 0,
                          "spill_loads": 0}}}
    lines, ok = KR.verdict(mine, other, pretty)
    assert not ok and "same SASS as bf16<1>" in lines[1]
    lines, ok = KR.verdict(mine, other, pretty, r"^f32<")
    assert ok and "(allowed to change)" in lines[0]
    assert not KR.verdict(mine, other, pretty, r"^bf16<")[1]
    mine["lib"]["a"]["spill_loads"] = 4
    lines, ok = KR.verdict(mine, other, pretty, r"^f32<")
    assert not ok and lines[0] == "[lib] f32_new<1> spills"
