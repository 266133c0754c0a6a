#!/usr/bin/env python3
"""Whether two checkouts' CUDA kernels compile to the same machine code.

    python3 tools/sass_diff.py PARENT CHANGE [NAME ...]

PARENT and CHANGE are roots of checkouts (``git archive`` of a commit
unpacked into a gitignored directory, say). Each NAME (default
``flash_attention`` and ``paged_attention``) is a library of
``flashinfer_tpu_torch/csrc/NAME.cu``: both trees' sources are built with
this checkout's ``jit.core.NVCC_FLAGS`` (no variant header), one nvcc a
library, all at once, into a temporary directory; ``cuobjdump -sass``
dumps each, and the instruction text (addresses, encodings and the
anonymous namespace's file hash dropped) of every kernel is compared.
Prints a line per NAME: equal or not, the kernels and instructions of
each side; exits 1 if one differs. Needs the CUDA toolkit (a machine with
the card).
"""

from __future__ import annotations

import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENC = re.compile(r"/\* 0x[0-9a-f]+ \*/")
# the anonymous namespace's name hashes the file: equal code, other names
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_")


def sass(nvcc: str, lib: str) -> dict:
    """Kernel name -> its instructions, from ``cuobjdump -sass``."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    kernels, name = {}, None
    for ln in out.splitlines():
        ln = _ANON.sub("_GLOBAL__N__", ln)
        if "Function :" in ln:
            name = ln.split("Function :", 1)[1].strip()
            kernels[name] = []
        elif name is not None and _ADDR.search(ln):
            text = _ENC.sub("", _ADDR.sub("", ln)).strip().rstrip(";").strip()
            if text:
                kernels[name].append(text)
    return kernels


def main() -> int:
    from flashinfer_tpu_torch.jit import core

    if len(sys.argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = sys.argv[1:3]
    names = sys.argv[3:] or ["flash_attention", "paged_attention"]
    nvcc = core._nvcc()
    tmp = tempfile.mkdtemp(prefix="sass_diff_")
    procs = {}
    for side, tree in zip(("parent", "change"), trees):
        csrc = os.path.join(tree, "flashinfer_tpu_torch", "csrc")
        for name in names:
            lib = os.path.join(tmp, f"{side}-{name}.so")
            procs[(side, name)] = (lib, subprocess.Popen(
                [nvcc, *core.NVCC_FLAGS, "-I", csrc,
                 os.path.join(csrc, f"{name}.cu"), "-o", lib],
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True))
    for (side, name), (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            print(f"nvcc failed for {side} {name}:\n{err}", file=sys.stderr)
            return 1
    differ = False
    for name in names:
        a = sass(nvcc, procs[("parent", name)][0])
        b = sass(nvcc, procs[("change", name)][0])
        same = a == b
        differ |= not same
        print(f"{name}: {'equal' if same else 'DIFFERENT'} SASS; parent "
              f"{len(a)} kernels / {sum(map(len, a.values()))} instructions, "
              f"change {len(b)} / {sum(map(len, b.values()))}")
        if not same:
            for k in sorted(set(a) | set(b)):
                x, y = a.get(k, []), b.get(k, [])
                if x != y:
                    pairs = [(i, u, v) for i, (u, v) in enumerate(zip(x, y))
                             if u != v]
                    print(f"  differs: {k[:120]} ({len(x)} / {len(y)} "
                          f"instructions, {len(pairs)} unequal), first:")
                    for i, u, v in pairs[:4]:
                        print(f"    [{i}] {u}  |  {v}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
