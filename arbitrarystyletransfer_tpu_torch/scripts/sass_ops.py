"""Opcode counts of the port's kernels, read from the SASS of the built
kernel library.

    python -m arbitrarystyletransfer_tpu_torch.scripts.sass_ops \\
        [PATTERN] [--lib PATH]

Runs the CUDA toolkit's ``cuobjdump -sass`` on the library (``--lib``, else
the newest ``libast_kernels_*.so`` in the build directory, else it builds
one) and prints one JSON object {kernel: {opcode: count}} for every kernel
whose mangled name contains PATTERN (default: every kernel).  An opcode
keeps its modifiers (``HFMA2.BF16_V2``, ``FFMA``), since they say which
unit runs it.  Counts are static: an unrolled loop body counts once per
copy, a loop's trip count not at all.
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


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("pattern", nargs="?", default="")
    p.add_argument("--lib", default=None)
    args = p.parse_args(argv)
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(library_path(args.lib))],
                          capture_output=True, text=True, check=True).stdout
    print(json.dumps(opcode_counts(sass, args.pattern), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
