"""Compare the SASS of two versions of one CUDA source, kernel by kernel.

    python -m zookeeper_tpu_torch.sass_diff OLD.cu NEW.cu [--rename PATTERN=REPLACEMENT|NAME]

Builds each source with the port's ``nvcc`` flags into a shared library
in a temporary directory, disassembles both with ``cuobjdump -sass`` and
compares every kernel's instructions. The anonymous-namespace tag that
``nvcc`` derives from the file, and the column padding that ``cuobjdump``
fits to the file's longest instruction, are normalised away, so a kernel
whose code did not change compares equal however the rest of the file
changed. ``--rename`` (repeatable) rewrites the old source's kernel names
with a regular expression before they are paired, so a kernel whose
template lost or gained a parameter is compared with its new name; a
NAME takes that rule from :data:`RULES`.
Prints one line per kernel (``same``, ``differs`` with the count of
differing instructions, ``only in old`` or ``only in new``) and, last, a
JSON summary. Exits 1 if a kernel present in both differs. Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``); runs on the machine with the card.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from zookeeper_tpu_torch.ops import cuda_build

#: Named ``--rename`` rules. ``split-paged``: the row-split decode
#: kernels of a ``decode_attention.cu`` whose split kernel served K13
#: alone (``decode_attention_split_kernel<QT, KT, DL, UNROLL>``) paired
#: with their ``PAGED=true`` instantiations of the template K12 and K13
#: share (``<QT, KT, PAGED, DL, UNROLL>``); the types before the first
#: ``int`` argument hold no ``L``, so a name that has its ``bool``
#: already is left alone.
RULES = {"split-paged": r"(decode_attention_split_kernelI[^L]*)(Li)=\1Lb1E\2"}

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_NAMESPACE_TAG = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_[0-9a-f]{8}")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(cuda_build._nvcc()), name)


def kernels_sass(source: str, workdir: str) -> Dict[str, List[str]]:
    """{mangled kernel name: SASS lines} of ``source`` built with
    ``cuda_build.NVCC_FLAGS``."""
    lib = os.path.join(workdir, "lib.so")
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", lib, source],
                   check=True, capture_output=True, text=True)
    return parse_sass(subprocess.run([_tool("cuobjdump"), "-sass", lib], check=True,
                                     capture_output=True, text=True).stdout)


def parse_sass(text: str) -> Dict[str, List[str]]:
    """Split ``cuobjdump -sass`` output into {kernel: instruction lines},
    the anonymous-namespace tag and the column padding normalised away."""
    out: Dict[str, List[str]] = {}
    current = None
    for line in _NAMESPACE_TAG.sub("_GLOBAL__N_", text).splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = m.group(1)
            out[current] = []
        elif current is not None and line.strip():
            # cuobjdump pads its columns to the file's longest
            # instruction, so runs of blanks are compared as one.
            out[current].append(" ".join(line.split()))
    return out


def rename(kernels: Dict[str, List[str]], rules: List[str]) -> Dict[str, List[str]]:
    """``kernels`` with every name rewritten by each ``PATTERN=REPLACEMENT``
    rule (or the name of one in :data:`RULES`) in turn (``re.sub``)."""
    for rule in rules:
        pattern, _, replacement = RULES.get(rule, rule).partition("=")
        kernels = {re.sub(pattern, replacement, name): code for name, code in kernels.items()}
    return kernels


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old")
    parser.add_argument("new")
    parser.add_argument("--rename", action="append", default=[],
                        metavar="PATTERN=REPLACEMENT|NAME",
                        help="regular expression rewriting the old kernels' names, or the "
                             f"name of one of {sorted(RULES)}")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        old, new = rename(kernels_sass(args.old, a), args.rename), kernels_sass(args.new, b)
    names = sorted(set(old) | set(new))
    summary = {"same": 0, "differs": 0, "only_in_old": 0, "only_in_new": 0}
    for name in names:
        if name not in new:
            verdict, key = "only in old", "only_in_old"
        elif name not in old:
            verdict, key = "only in new", "only_in_new"
        elif old[name] == new[name]:
            verdict, key = f"same ({len(new[name])} instructions)", "same"
        else:
            changed = sum(x != y for x, y in zip(old[name], new[name]))
            changed += abs(len(old[name]) - len(new[name]))
            verdict, key = f"differs ({changed} instructions)", "differs"
        summary[key] += 1
        print(f"{verdict}: {name}", flush=True)
    print(json.dumps(summary), flush=True)
    return 1 if summary["differs"] else 0


if __name__ == "__main__":
    sys.exit(main())
