"""``kernels/sass.py`` on hand-written SASS: where a kernel's global loads
sit against their first use (load rounds), and the readable kernel names.
The chip check's load-round report rests on these two functions; the SASS
here follows ``cuobjdump -sass``'s layout, so nothing needs the toolkit."""

import pytest

from repro_torch.kernels import sass


def listing(*instrs: str) -> str:
    """A function body as ``cuobjdump -sass`` prints it: an address comment,
    the instruction, its encoding comment."""
    return "\n".join(f"        /*{16 * i:04x}*/                   {ins} ;"
                     f"                  /* 0x000fe20000000f00 */"
                     for i, ins in enumerate(instrs)) + "\n"


# ids, then every column issued before the first use: two rounds
TWO_ROUNDS = listing(
    "LDC R1, c[0x0][0x28]",
    "S2R R0, SR_TID.X",
    "ULDC.64 UR4, c[0x0][0x208]",
    "LDG.E.CONSTANT R2, desc[UR4][R10.64]",
    "SHFL.IDX PT, R3, R2, RZ, 0x1f",
    "IMAD.WIDE R4, R3, 0x4, R12",
    "LDG.E.CONSTANT R6, desc[UR4][R4.64]",
    "LDG.E.CONSTANT R7, desc[UR4][R4.64+0x80]",
    "@P0 LDG.E.U8.CONSTANT R8, desc[UR4][R14.64]",
    "LDG.E.64.CONSTANT R16, desc[UR4][R18.64]",
    "FADD R9, R6, R7",
    "FADD R9, R9, R17",
    "ISETP.NE.AND P1, PT, R8, RZ, PT",
    "STG.E desc[UR4][R20.64], R9",
    "EXIT",
)

# a column widened between two loads: its use closes a round of its own
THREE_ROUNDS = listing(
    "LDG.E R2, desc[UR4][R10.64]",
    "IMAD.WIDE R4, R2, 0x4, R12",
    "LDG.E R6, desc[UR4][R4.64]",
    "I2F R7, R6",
    "LDG.E R8, desc[UR4][R4.64+0x80]",
    "FADD R9, R7, R8",
    "STG.E desc[UR4][R20.64], R9",
    "EXIT",
)

# kernel parameters from the constant bank are not loads of device memory
CONSTANT_BANK = listing(
    "LDC R2, c[0x0][0x210]",
    "ULDC UR6, c[0x0][0x218]",
    "LDC.64 R4, c[0x0][0x220]",
    "IADD3 R6, R2, UR6, RZ",
    "LDG.E R7, desc[UR4][R4.64]",
    "IMAD R8, R2, R6, RZ",
    "FADD R9, R7, R7",
    "EXIT",
)


@pytest.mark.parametrize("text, rounds", [
    (TWO_ROUNDS, [(1, "0040"), (4, "00a0")]),
    (THREE_ROUNDS, [(1, "0010"), (1, "0030"), (1, "0050")]),
    (CONSTANT_BANK, [(1, "0060")]),
    (listing("LDG.E R2, desc[UR4][R10.64]", "LDG.E R3, desc[UR4][R10.64+0x4]"),
     [(2, "end")]),
    (listing("LDC R1, c[0x0][0x28]", "EXIT"), []),
], ids=["two_rounds", "use_between_loads", "constant_bank", "never_used", "no_load"])
def test_load_rounds(text, rounds):
    assert sass.load_rounds(text) == rounds


def test_a_load_overwritten_before_use_is_not_waited_on():
    """A register a load wrote but an ALU op overwrote is no longer pending:
    reading it later waits on no load."""
    text = listing("LDG.E R2, desc[UR4][R10.64]",
                   "MOV R2, RZ",
                   "FADD R3, R2, R2",
                   "LDG.E R4, desc[UR4][R10.64+0x4]",
                   "FADD R5, R4, R4")
    assert sass.load_rounds(text) == [(2, "0040")]


@pytest.mark.parametrize("mangled, name", [
    ("_ZN11repro_torch19filtered_agg_kernelILi4ELb0EEEvNS_9RawColumnES1_S1_S1_"
     "S1_PKhPKiiiPKfPf", "filtered_agg_kernel<4, false>"),
    ("_ZN11repro_torch16block_agg_kernelILi1ELb1EEEvNS_9RawColumnEPKhPKiiiPf",
     "block_agg_kernel<1, true>"),
    ("_ZN11repro_torch19column_floor_kernelEv", "column_floor_kernel"),
    ("_Z9my_kernelPf", "_Z9my_kernelPf"),
])
def test_readable(mangled, name):
    assert sass.readable(mangled) == name


def test_split_functions_keys_each_kernel_by_its_readable_name():
    text = ("\n\tcode for sm_90a\n"
            "\t\tFunction : _ZN11repro_torch16block_agg_kernelILi2ELb0EEEvNS_9RawColumnEPKhPKiiiPf\n"
            + THREE_ROUNDS
            + "\t\tFunction : _ZN11repro_torch19column_floor_kernelEv\n"
            + listing("EXIT"))
    funcs = sass.split_functions(text)
    assert list(funcs) == ["block_agg_kernel<2, false>", "column_floor_kernel"]
    assert [n for n, _ in sass.load_rounds(funcs["block_agg_kernel<2, false>"])] == [1, 1, 1]
    assert sass.load_rounds(funcs["column_floor_kernel"]) == []
