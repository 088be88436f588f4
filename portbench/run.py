"""portbench: the benchmark of mpc_limx_control_tpu_torch on CUDA cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1> [--control tf32]

Run from the root of a checkout. The workload is a cell of BENCHMARK.json:
it names a configuration (portbench/configs/<config>.json) and a traffic
mix (portbench/mixes/<traffic>.json); the mix names its driver
(portbench/drivers/<driver>.py), which builds the cell's inputs from the
seed, warms up every shape the window uses, runs the window for
``--seconds``, and compares what the window produced with the plain
reference (portbench/reference). ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones (each read by
portbench/metrics/<metric>.py from a torch.profiler window). The last line
of standard output is one JSON object: correct, attempted, failed,
metrics, device, with --trace 1 also breakdown, and last the numbers
compared with their limits (``checks``), which also end standard error.

``--control tf32`` judges the reference computed in float32 with TF32
matrix products in the program's place (the control that the limits were
set against); the benchmark's own runs never pass it.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with a code other than 0; so it does when a module of
JAX or of the JAX package is loaded in the process once the window has
closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that neither the run nor the reference may load;
# the reference may also load nothing of the port
FORBIDDEN = ("jax", "jaxlib", "chex", "flax", "mpc_limx_control_tpu")
PORT = "mpc_limx_control_tpu_torch"
FORBIDDEN_REFERENCE = FORBIDDEN + (PORT,)


def forbidden_loaded(module_names, forbidden=FORBIDDEN) -> list:
    """The loaded modules whose top-level name (before the first dot) is
    one of `forbidden`, compared whole: the port's name begins with the
    JAX package's and is not the JAX package."""
    bad = set(forbidden)
    return sorted(m for m in module_names if m.split(".", 1)[0] in bad)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """portbench/<kind>/<name>.py as a module (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_of(manifest: dict, workload: str) -> dict:
    """The cell's entry, its configuration entry and its metric lists."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]

    def listed(m):
        return "workloads" not in m or workload in m["workloads"]

    e2e = [m for m in manifest["end_to_end"] if listed(m)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if ("workloads" in m and workload in m["workloads"])
                 or ("workloads" not in m and m["moves"] in names)]
    return {"cell": cell, "config": config, "end_to_end": e2e,
            "per_layer": per_layer}


def card(chips: int) -> dict:
    """The card's name and count; exits without enough cards."""
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is "
              "False); no result", file=sys.stderr)
        sys.exit(3)
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} cards, "
              f"{torch.cuda.device_count()} present; no result",
              file=sys.stderr)
        sys.exit(3)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


def power_limit():
    """The card's power limit as nvidia-smi states it (read after the
    window: it is no part of set-up)."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return smi[0].strip() if smi else None


def checks_text(checks: list) -> str:
    return "\n".join(
        f"check {c['name']}: {c['value']!r} {c['op']} {c['limit']!r} "
        f"{'ok' if c['ok'] else 'FAIL'}" for c in checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None,
                    help="judge the reference in TF32 in the program's "
                         "place (calibration only)")
    args = ap.parse_args(argv)

    manifest = load_json(ROOT / "BENCHMARK.json")
    spec = cell_of(manifest, args.workload)
    cfg_spec = load_json(ROOT / spec["config"]["file"])
    mix = load_json(HERE / "mixes" / f"{spec['cell']['traffic']}.json")
    driver = load_module("drivers", mix["driver"])
    device = card(int(spec["cell"]["chips"]))

    # caches of the program stay in the checkout (the kernels build into
    # build/torch_kernels, the wire library into build/)
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    import torch

    torch.cuda.reset_peak_memory_stats()
    cell = driver.Cell(cfg_spec, mix, args.seed, torch.device("cuda", 0),
                       trace=bool(args.trace))
    try:
        cell.setup()
        setup_s = time.perf_counter() - T_START
        out = cell.window(args.seconds)
        torch.cuda.synchronize()
        device["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        device["power_limit"] = power_limit()
        if args.trace:
            from portbench import trace

            record = cell.record()
            metrics = {}
            for m in spec["per_layer"]:
                v = load_module("metrics", m["name"]).read(record)
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
            lo, hi = record["window"]
            device["busy_s"] = trace.busy_us(record) * 1e-6
            device["window_s"] = (hi - lo) * 1e-6
            bd = trace.breakdown(record)
        else:
            metrics = {}
            for m in spec["end_to_end"]:
                v = setup_s if m["name"] == "setup_s" \
                    else out["metrics"].get(m["name"])
                if v is not None:
                    metrics[m["name"]] = {"value": float(v),
                                          "unit": m["unit"]}
        cell.release()
        t_check = time.perf_counter()
        checks = cell.check(control=args.control)
        out.setdefault("notes", {})["check_s"] = \
            time.perf_counter() - t_check
    finally:
        cell.close()
    bad = forbidden_loaded(list(sys.modules))
    if bad:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{bad}; no result", file=sys.stderr)
        return 4
    correct = all(c["ok"] for c in checks)
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": metrics,
            "device": device}
    if args.trace:
        line["breakdown"] = bd
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                      for c in checks}
    for k, v in out.get("notes", {}).items():
        print(f"note {k}: {v}", file=sys.stderr)
    print(checks_text(checks), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
