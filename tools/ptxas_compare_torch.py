"""Build the kernel library of two checkouts and compare the resource use
ptxas reports for each kernel (registers, barriers, shared memory, stack
and spills).

Run on a machine with ``nvcc``:

    python3 tools/ptxas_compare_torch.py --roots PARENT CHANGE \
        [--out chiprun_out/ptxas_compare.json]

Each checkout's ``mpc_limx_control_tpu_torch/ops/_build.py`` builds its
own library, in its own ``build/torch_kernels/``, in a process of its own
(both at once); a library already built there is built again in a fresh
directory, so that the compilers' report exists. The reports are read with
this checkout's ``_build.ptxas_resources``. Prints one JSON line: per
source file, how many kernels each side has, and the kernels whose line
differs or that one side lacks; ``--out`` also writes every kernel's two
lines.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mpc_limx_control_tpu_torch.ops import _build  # noqa: E402

BUILD = """
import json, sys, pathlib
sys.path.insert(0, {root!r})
from mpc_limx_control_tpu_torch.ops import _build
_build.BUILD_DIR = pathlib.Path({build!r})
print(json.dumps(_build.build_library()["log"]))
"""


def build_log(root: str) -> subprocess.Popen:
    build = tempfile.mkdtemp(prefix="ptxas_", dir=str(Path(root) / "build"))
    return subprocess.Popen(
        [sys.executable, "-c", BUILD.format(root=str(Path(root).resolve()),
                                            build=build)],
        stdout=subprocess.PIPE, text=True, cwd=root)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", nargs=2, required=True,
                    metavar=("A", "B"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    for root in args.roots:
        (Path(root) / "build").mkdir(exist_ok=True)
    procs = [build_log(r) for r in args.roots]
    logs = []
    for r, p in zip(args.roots, procs):
        out = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"the build of {r} failed ({p.returncode})")
        logs.append(json.loads(out.strip().splitlines()[-1]))
    a, b = (_build.ptxas_resources(log) for log in logs)
    sources = sorted({s for s, _ in a} | {s for s, _ in b})
    report = {}
    for src in sources:
        ka = {k for k in a if k[0] == src}
        kb = {k for k in b if k[0] == src}
        report[src] = dict(
            kernels=[len(ka), len(kb)],
            differ=sorted(k[1] for k in ka & kb if a[k] != b[k]),
            only_a=sorted(k[1] for k in ka - kb),
            only_b=sorted(k[1] for k in kb - ka))
    same = [s for s, r in report.items()
            if not (r["differ"] or r["only_a"] or r["only_b"])]
    print(json.dumps(dict(roots=args.roots, identical_sources=same,
                          report=report)), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {f"{s}:{n}": [a.get((s, n)), b.get((s, n))]
             for s, n in sorted(set(a) | set(b))}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
