"""Compare the SASS of two versions of one CUDA source, kernel by kernel.

    python -m zookeeper_tpu_torch.sass_diff OLD.cu NEW.cu

Builds each source with the port's ``nvcc`` flags into a shared library
in a temporary directory, disassembles both with ``cuobjdump -sass`` and
compares every kernel's instructions. The anonymous-namespace tag that
``nvcc`` derives from the file is normalised away, so a kernel whose code
did not change compares equal however the rest of the file changed.
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
    the anonymous-namespace tag normalised away."""
    out: Dict[str, List[str]] = {}
    current = None
    for line in _NAMESPACE_TAG.sub("_GLOBAL__N_", text).splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = m.group(1)
            out[current] = []
        elif current is not None and line.strip():
            out[current].append(line.strip())
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old")
    parser.add_argument("new")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        old, new = kernels_sass(args.old, a), kernels_sass(args.new, b)
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
