"""Instructions per element in the main loop of the noise kernels, counted
in the SASS of a built kernel library (``cuobjdump -sass``).

    python3 -m psgd_torch_tpu_torch.ops.sass build/kernels/libpsgd_kernels_<hash>.so

For each instantiation of ``noise_kernel`` (and of the complex mode's
``noise_complex_kernel``, per complex element) it takes the longest span
between a backward branch and its target (the grid-stride loop), counts
its instructions, its ``IMAD.WIDE`` and ``IMAD.HI`` (the integer multiplies
of Philox, which issue on the half-rate pipe) and the bytes its global
stores write, and divides by the elements one pass of the loop stores.
chip_smoke.py turns these counts into the noise kernel's instruction
bound.  Needs the CUDA toolkit's cuobjdump (the machine with the card);
the parsing itself is plain text and runs anywhere.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+([^;]*);")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
# a branch's target: a label (.L_x_N, as `(.L_x_N)) or an address (0x...),
# the last operand whatever predicates come before it
_TARGET = re.compile(r"(\.L_x_\d+|0x[0-9a-f]+)")
_PRED = re.compile(r"^@!?U?P\w+\s+")
# noise_kernel<T, kFused[, kOct]> and noise_complex_kernel<T, kFused, kVec>
_NOISE = re.compile(r"noise_kernelI(f|13__nv_bfloat16)Lb([01])E(?:Lb([01])E)?")
_COMPLEX = re.compile(r"noise_complex_kernelI(f|d)Lb([01])ELb([01])E")


def _cuobjdump() -> str:
    for cand in (shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and shutil.which(cand):
            return cand
    raise RuntimeError("cuobjdump not found: it comes with the CUDA toolkit")


def split_functions(sass: str) -> dict[str, list[str]]:
    """SASS lines of each function in a ``cuobjdump -sass`` listing, keyed
    by mangled name."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def functions(lib: str) -> dict[str, list[str]]:
    """SASS lines of each function in the library, keyed by mangled name."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    return split_functions(out)


def _opcode(ins: str) -> str:
    return _PRED.sub("", ins).split()[0]


def _store_bytes(op: str) -> int:
    for suffix, size in ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2),
                         (".U8", 1), (".S8", 1)):
        if suffix in op:
            return size
    return 4


def main_loop(lines: list[str]) -> dict:
    """The longest loop of one function: instructions, IMAD.WIDE/IMAD.HI
    and global store bytes in one pass."""
    instrs, labels, pending = [], {}, []
    for line in lines:
        if m := _LABEL.match(line):
            pending.append(m.group(1))
            continue
        if m := _INSTR.match(line):
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            instrs.append((addr, m.group(2).strip()))
    best = None
    for addr, ins in instrs:
        if not _opcode(ins).startswith("BRA"):
            continue
        targets = _TARGET.findall(ins)
        if not targets:
            continue
        target = targets[-1]
        start = int(target, 16) if target.startswith("0x") else labels.get(target)
        if start is not None and start <= addr:
            span = [i for a, i in instrs if start <= a <= addr]
            if best is None or len(span) > len(best):
                best = span
    if best is None:
        raise ValueError("no loop found in:\n" + "\n".join(lines[:60]))
    ops = [_opcode(ins) for ins in best]
    return {"instructions": len(best),
            "imad_wide_hi": sum(op.startswith(("IMAD.WIDE", "IMAD.HI")) for op in ops),
            "store_bytes": sum(_store_bytes(op) for op in ops if op.startswith("STG"))}


def noise_loops_of(funcs: dict[str, list[str]]) -> dict[tuple, dict]:
    """{(dtype, fused, vector or None): main-loop counts per element} for
    every noise_kernel instantiation among ``funcs`` (f32 and bf16), and
    per complex element for every noise_complex_kernel (complex64 and
    complex128)."""
    out = {}
    for name, lines in funcs.items():
        if m := _COMPLEX.search(name):
            size = 8 if m.group(1) == "f" else 16
            dtype = "complex64" if size == 8 else "complex128"
        elif m := _NOISE.search(name):
            size = 4 if m.group(1) == "f" else 2
            dtype = "float32" if size == 4 else "bfloat16"
        else:
            continue
        loop = main_loop(lines)
        elems = loop["store_bytes"] / size
        if not elems:
            raise ValueError(f"{name}: its longest loop stores nothing")
        key = (dtype, m.group(2) == "1",
               None if m.group(3) is None else m.group(3) == "1")
        out[key] = dict(loop, elements=elems,
                        per_element=loop["instructions"] / elems,
                        imad_per_element=loop["imad_wide_hi"] / elems)
    return out


def noise_loops(lib: str) -> dict[tuple, dict]:
    """``noise_loops_of`` the functions of a built library."""
    return noise_loops_of(functions(lib))


if __name__ == "__main__":
    for key, c in sorted(noise_loops(sys.argv[1]).items(), key=str):
        dtype, fused, vec = key
        print(f"noise_kernel {dtype} {'fused' if fused else 'unit'} "
              f"{'' if vec is None else ('vector' if vec else 'scalar')}: "
              f"{c['instructions']} instructions, {c['imad_wide_hi']} IMAD.WIDE/HI, "
              f"{c['elements']:g} elements per pass: {c['per_element']:.2f} "
              f"instructions and {c['imad_per_element']:.2f} IMAD.WIDE/HI per element")
