"""Count the SASS instructions of the port's kernels (``cuobjdump -sass``).

    python -m safelife_torch.scripts.sass_count [LIBRARY.so ...]

Without arguments it builds the libraries of ``csrc/`` (``nvcc`` needed)
and reads ``life_kernels``, ``env_step_kernels``, ``obs_micro`` and
``view_kernels``.  For each kernel it
prints the static instruction count, a digest of its instructions (the
same digest in two builds means the same machine code: addresses and
comments are left out) and each loop, found as a backward branch, with its
instructions and its memory operations.  A loop's cells per iteration are
its cell-sized stores: one for each 16-bit store (``STG.E.U16``,
``STS.U16``), each count-word store into shared memory (``STS``,
``STS.64``) and each 32- or 64-bit store to device memory (``STG.E``,
``STG.E.64``: a cell of S5's lane word of 2 or 4 environments), eight for
each 16-byte store or ``cp.async``
(``STG.E.128``, ``LDGSTS.E.BYPASS.128``), since a 16-byte access moves one
cell of 8 environments.  Instructions a cell = the loop's instructions /
its cells.  Static counts: every path of a loop's body is counted, taken
or not.
"""

import collections
import hashlib
import os
import re
import shutil
import subprocess
import sys

from ..ops import _build

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?);")
_FUNC = re.compile(r"^\s*Function : (\S+)")
# Memory operations by class (base opcode and width in bits), and the
# cells one store of each class writes.
_CELL_STORES = {"STG.16": 1, "STG.32": 1, "STG.64": 1,
                "STS.16": 1, "STS.32": 1, "STS.64": 1,
                "STG.128": 8, "LDGSTS.128": 8}
_WIDTHS = {"U8": 8, "S8": 8, "U16": 16, "S16": 16, "64": 64, "128": 128}


def _tool(name):
    path = shutil.which(name) or os.path.join("/usr/local/cuda/bin", name)
    if not os.path.exists(path):
        raise RuntimeError(f"{name} not found: SASS cannot be read here")
    return path


def _demangle(names):
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if not filt:
        return dict(zip(names, names))
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return dict(zip(names, out))


def functions(library):
    """{mangled name: [(address, instruction text)]} of ``library``."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2).strip()))
    return funcs


def _opcode(text):
    """The opcode with its modifiers, the predicate left out."""
    words = text.split()
    if words and words[0].startswith("@"):
        words = words[1:]
    return words[0] if words else ""


def _memory_class(op):
    """"LDG.16", "STS.64", ... for a load or store, else None."""
    base, *mods = op.split(".")
    if base not in ("LDG", "STG", "LDS", "STS", "LDGSTS"):
        return None
    width = next((_WIDTHS[m] for m in mods if m in _WIDTHS), 32)
    return f"{base}.{width}"


def loops(insns):
    """[(first address, last address, instructions, memory op counts)] of
    each backward branch's range."""
    addrs = [a for a, _ in insns]
    out = []
    for i, (addr, text) in enumerate(insns):
        if not _opcode(text).startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", text)
        if not m:
            continue
        target = int(m.group(1), 16)
        if target >= addr:
            continue
        first = addrs.index(target) if target in addrs else None
        if first is None:
            continue
        body = insns[first:i + 1]
        mem = collections.Counter(
            c for c in (_memory_class(_opcode(t)) for _, t in body) if c)
        out.append((target, addr, len(body), dict(mem)))
    return out


def digest(insns):
    """A digest of the instructions without their addresses."""
    text = "\n".join(re.sub(r"0x[0-9a-f]+", "ADDR", t) for _, t in insns)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def report(library):
    funcs = functions(library)
    names = _demangle(list(funcs))
    print(f"{library}: {len(funcs)} kernels")
    for mangled, insns in sorted(funcs.items(), key=lambda kv: names[kv[0]]):
        print(f"  {names[mangled]}\n    {len(insns)} instructions, digest "
              f"{digest(insns)}")
        for first, last, n, mem in loops(insns):
            cells = sum(_CELL_STORES.get(c, 0) * k for c, k in mem.items())
            per = f", {n / cells:.1f} a cell" if cells else ""
            print(f"    loop {first:#06x}-{last:#06x}: {n} instructions, "
                  f"{cells} cells{per}; {mem}")


def main(argv=None):
    args = sys.argv[1:] if argv is None else argv
    if not args:
        built = _build.build_all()
        args = [built[name][0] for name in (
            "life_kernels", "env_step_kernels", "obs_micro", "view_kernels")]
    for library in args:
        report(library)


if __name__ == "__main__":
    main()
