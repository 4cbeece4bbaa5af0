"""Opcode counts of the port's kernels, read from the SASS of the built
kernel library.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sass_ops \\
        [PATTERN] [--lib PATH] [--diff OTHER]

Runs the CUDA toolkit's ``cuobjdump -sass`` on the library (``--lib``, else
the newest ``libast_kernels_*.so`` in the build directory, else it builds
one) and prints one JSON object {kernel: {opcode: count}} for every kernel
whose mangled name contains PATTERN (default: every kernel).  An opcode
keeps its modifiers (``HFMA2.BF16_V2``, ``FFMA``), since they say which
unit runs it.  Counts are static: an unrolled loop body counts once per
copy, a loop's trip count not at all.  With ``--diff OTHER`` (another
build of the library, e.g. a parent commit's) it instead compares each
kernel's instructions in the two libraries and prints {"equal": n,
"differ": [...], "renamed_equal": [[name, other name], ...], "only_lib":
[...], "only_other": [...]}: the names of anonymous namespaces, which
carry hashes of the source, are made equal first, and the instructions
are compared without their addresses and encodings; a kernel whose name
is in one library only is paired with one of the other's whose
instructions are the same (a template or kernel argument added).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

from ..ops.kernels import _build

_FUNCTION = re.compile(r"^\s*Function : (\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                    r"([A-Z][A-Z0-9_.]*)")
_TEXT = re.compile(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def library_path(lib: str | None) -> Path:
    if lib:
        return Path(lib)
    out_dir = Path(os.environ.get("AST_TORCH_BUILD_DIR",
                                  _build._PKG.parent / "build" / "kernels"))
    built = sorted(out_dir.glob("libast_kernels_*.so"),
                   key=lambda p: p.stat().st_mtime)
    if built:
        return built[-1]
    _build.load_library()
    return Path(_build.build_info["path"])


def opcode_counts(sass: str, pattern: str = "") -> dict:
    """{kernel: {opcode: count}} of ``cuobjdump -sass`` output."""
    counts, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = m.group(1) if pattern in m.group(1) else None
            if current is not None:
                counts[current] = Counter()
            continue
        m = _INSTR.search(line) if current is not None else None
        if m:
            counts[current][m.group(1)] += 1
    return {k: dict(v.most_common()) for k, v in counts.items()}


def kernel_texts(sass: str) -> dict:
    """{kernel: [instruction, ...]} of ``cuobjdump -sass`` output, the
    anonymous namespaces' hashes dropped from the names."""
    texts, current = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = _ANON.sub(r"_GLOBAL__N__\1", m.group(1))
            texts[current] = []
            continue
        m = _TEXT.search(line) if current is not None else None
        if m:
            texts[current].append(" ".join(m.group(1).split()))
    return texts


def diff(sass: str, other: str) -> dict:
    """Which kernels of two libraries' SASS are equal, differ, are equal
    under another name, or are in one only."""
    a, b = kernel_texts(sass), kernel_texts(other)
    both = sorted(set(a) & set(b))
    only_b = {}
    for k in sorted(set(b) - set(a)):
        only_b.setdefault(tuple(b[k]), []).append(k)
    renamed, only_a = [], []
    for k in sorted(set(a) - set(b)):
        twins = only_b.get(tuple(a[k]))
        if twins:
            renamed.append([k, twins.pop(0)])
        else:
            only_a.append(k)
    return {"equal": sum(a[k] == b[k] for k in both),
            "differ": [k for k in both if a[k] != b[k]],
            "renamed_equal": renamed, "only_lib": only_a,
            "only_other": sorted(k for ks in only_b.values() for k in ks)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pattern", nargs="?", default="")
    p.add_argument("--lib", default=None)
    p.add_argument("--diff", default=None,
                   help="compare each kernel with this library's")
    args = p.parse_args(argv)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")

    def dump(path):
        return subprocess.run([str(cuobjdump), "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout

    sass = dump(library_path(args.lib))
    if args.diff:
        print(json.dumps(diff(sass, dump(args.diff)), indent=1))
        return 0
    print(json.dumps(opcode_counts(sass, args.pattern), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
