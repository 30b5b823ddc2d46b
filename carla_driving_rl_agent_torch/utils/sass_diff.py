"""Compare the SASS of two versions of a CUDA source, kernel by kernel.

    python -m carla_driving_rl_agent_torch.utils.sass_diff OLD_DIR NEW_DIR \
        [--source shuffle_unit.cu] [--match 'I(ff|dd)'] [--raw]

Each directory holds a version of the source and the headers it includes
(for example one unpacked with `git show REV:path`).  Both are compiled
with the port's nvcc flags to a cubin for sm_90a and disassembled with the
toolkit's cuobjdump; every kernel whose mangled name matches `--match` is
compared instruction by instruction, after the anonymous namespace's hash
and (unless `--raw`) the kernel parameters' constant-bank offsets are
normalised: a field added to a kernel's argument struct shifts those
offsets and nothing else.  Prints one line per kernel, the first lines of
each difference, and a summary; exits 1 when a kernel differs or is
missing.  Needs the CUDA toolkit (the card's machine has it).
"""

from __future__ import annotations

import argparse
import difflib
import os
import re
import subprocess
import sys
import tempfile
from typing import Dict, List

from carla_driving_rl_agent_torch.utils.build import NVCC_FLAGS, _nvcc

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]+")
_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def kernels_sass(source: str, raw: bool = False) -> Dict[str, List[str]]:
    """{normalised mangled name: its instructions} of the kernels `source`
    compiles to."""
    nvcc = _nvcc()
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([nvcc] + flags + ["-cubin", "-o", cubin, source], check=True)
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"), "-sass", cubin],
                              capture_output=True, text=True, check=True).stdout
    out = {}
    for f in re.split(r"\n\s+Function : ", sass)[1:]:
        name, body = f.split("\n", 1)
        ins = re.findall(r"/\*[0-9a-f]{4}\*/\s+([^;]*;)", _ANON.sub("ANON", body))
        out[_ANON.sub("ANON", name.strip())] = ins if raw else [_PARAM.sub("c[0x0][P]", i)
                                                              for i in ins]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_dir")
    ap.add_argument("new_dir")
    ap.add_argument("--source", default="shuffle_unit.cu")
    ap.add_argument("--match", default="", help="regex on the mangled kernel names")
    ap.add_argument("--raw", action="store_true",
                    help="compare the parameters' constant-bank offsets too")
    args = ap.parse_args(argv)
    old, new = (kernels_sass(os.path.join(d, args.source), args.raw)
                for d in (args.old_dir, args.new_dir))
    same = differ = 0
    for name in sorted(k for k in old if re.search(args.match, k)):
        a, b = old[name], new.get(name)
        ok = a == b
        same, differ = same + ok, differ + (not ok)
        print(f"  {'identical' if ok else 'DIFFERS'}: {name} ({len(a)} / "
              f"{'missing' if b is None else len(b)} instructions)", flush=True)
        if b is not None and not ok:
            lines = [x for x in difflib.unified_diff(a, b, lineterm="", n=0) if x[:1] in "+-"]
            print("    " + "\n    ".join(lines[:20]), flush=True)
    print(f"sass_diff {args.source}: {same} kernels identical, {differ} differ"
          f"{'' if args.raw else ' (parameter offsets normalised)'}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
