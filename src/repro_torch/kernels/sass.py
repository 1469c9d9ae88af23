"""Where a built kernel's global loads sit against their first use, read
from the SASS that ``cuobjdump -sass`` prints for a built library.

    PYTHONPATH=src python -m repro_torch.kernels.sass build/kernels/libfiltered_agg-*.so

For each kernel of the library, the SASS is walked in program order and cut
into *load rounds*: a round is the ``LDG`` instructions issued after the
previous round closed, and it closes at the first instruction that reads a
register one of its loads (or an earlier round's) writes — where the warp
first waits on memory.  A kernel whose warp loads its ids, then every
column, then computes has two rounds on its straight-line path; a kernel
that loads a column, tests it, then loads the next has more, each a
device-memory latency paid in turn.  Reads from the constant bank (``LDC``,
``ULDC``) are kernel parameters, not loads of device memory, and do not
count.
"""

from __future__ import annotations

import re
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.kernels import _build

_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_REG = re.compile(r"(?<![A-Z])R(\d+)(\.64|\.128)?")
# opcodes whose first operand is read, not written
_NO_DEST = {"ST", "STG", "STS", "STL", "RED", "REDG", "ATOM", "ATOMG", "BRA",
            "EXIT", "BAR", "BSYNC", "BSSY", "RET", "CALL", "WARPSYNC", "NOP",
            "MEMBAR", "DEPBAR", "ERRBAR", "CCTL", "YIELD"}
_WIDTH = {".64": 2, ".128": 4}


def _regs(text: str) -> List[int]:
    out = []
    for m in _REG.finditer(text):
        base = int(m.group(1))
        out.extend(range(base, base + _WIDTH.get(m.group(2), 1)))
    return out


def _split(instr: str) -> Tuple[str, List[str]]:
    """(opcode with modifiers, operands) of one SASS instruction, its
    predicate guard dropped."""
    instr = re.sub(r"^@!?U?P\w+\s+", "", instr)
    op, _, rest = instr.partition(" ")
    return op, [o.strip() for o in rest.split(",")] if rest else []


def load_rounds(sass: str) -> List[Tuple[int, str]]:
    """The load rounds of one function's SASS: [(LDGs in the round, address
    of the instruction that closed it), ...] in program order."""
    rounds: List[Tuple[int, str]] = []
    pending: set = set()
    loads = 0
    for addr, instr in _INSTR.findall(sass):
        op, args = _split(instr)
        base = op.split(".")[0]
        if base in _NO_DEST:
            writes, reads = [], args
        elif base == "SHFL":
            writes, reads = args[1:2], args[2:]
        elif base.endswith("SETP"):
            writes, reads = [], args[2:]
        else:
            writes, reads = args[:1], args[1:]
        used = pending.intersection(_regs(" ".join(reads)))
        if used:
            if loads:
                rounds.append((loads, addr))
                loads = 0
            pending -= used
        if base == "LDG":
            width = next((w for m, w in _WIDTH.items() if m in op), 1)
            first = _regs(writes[0])[:1] if writes else []
            pending.update(range(first[0], first[0] + width) if first else [])
            loads += 1
        else:
            pending.difference_update(_regs(" ".join(writes)))
    if loads:
        rounds.append((loads, "end"))
    return rounds


def readable(mangled: str) -> str:
    """``name<1, false>`` from an Itanium-mangled kernel name of the
    ``repro_torch`` namespace with int and bool template arguments (the raw
    name where it does not parse)."""
    m = re.match(r"_ZN\d+repro_torch(\d+)", mangled)
    if not m:
        return mangled
    n = int(m.group(1))
    name = mangled[m.end():m.end() + n]
    t = re.match(r"I((?:L[ib]\d+E)+)E", mangled[m.end() + n:])
    if not t:
        return name
    args = [v if kind == "i" else ("true" if v == "1" else "false")
            for kind, v in re.findall(r"L([ib])(\d+)E", t.group(1))]
    return f"{name}<{', '.join(args)}>"


def split_functions(text: str) -> Dict[str, str]:
    """Each kernel of ``cuobjdump -sass`` output and its SASS text, keyed by
    its readable name."""
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    return {readable(parts[i]): parts[i + 1] for i in range(1, len(parts) - 1, 2)}


def functions(library: Path) -> Dict[str, str]:
    """Each kernel of a built library and its SASS text."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], check=True,
                          capture_output=True, text=True, timeout=120).stdout
    return split_functions(text)


def kernel_rounds(library: Path) -> Dict[str, List[int]]:
    """Each kernel of a built library and its load rounds, as LDG counts."""
    return {name: [n for n, _ in load_rounds(sass)]
            for name, sass in sorted(functions(library).items())}


def report(library: Path) -> List[str]:
    """One line per kernel: its load rounds, as LDG counts."""
    return [f"{name}: {sum(rounds)} LDG in {len(rounds)} rounds {rounds}"
            for name, rounds in kernel_rounds(library).items()]


if __name__ == "__main__":
    for lib in sys.argv[1:]:
        print(f"[sass] {lib}")
        for line in report(Path(lib)):
            print(f"[sass]   {line}")
