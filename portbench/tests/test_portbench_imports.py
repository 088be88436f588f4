"""What the run and the reference may load: JAX and the JAX package never;
the reference nothing of the port either. Top-level module names are
compared whole: the port's name begins with the JAX package's."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import run  # noqa: E402


def test_top_level_names_are_compared_whole():
    mods = ["mpc_limx_control_tpu_torch", "mpc_limx_control_tpu_torch.ops",
            "jaxtyping", "chexx", "numpy"]
    assert run.forbidden_loaded(mods) == []
    assert run.forbidden_loaded(mods + ["jax.numpy", "jaxlib"]) == \
        ["jax.numpy", "jaxlib"]
    assert run.forbidden_loaded(["mpc_limx_control_tpu.control",
                                 "chex"]) == ["chex",
                                              "mpc_limx_control_tpu.control"]
    assert run.forbidden_loaded(
        mods, run.FORBIDDEN_REFERENCE) == \
        ["mpc_limx_control_tpu_torch", "mpc_limx_control_tpu_torch.ops"]


def _loaded_by(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print('\\n'.join(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
             "HOME": str(ROOT / "build")})
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.split()


def test_the_run_loads_no_jax():
    """run.py, every driver, every metric and the port's modules the
    drivers call."""
    mods = _loaded_by(
        "from portbench import run\n"
        "import glob, os\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for f in glob.glob(f'portbench/{kind}/*.py'):\n"
        "        n = os.path.basename(f)[:-3]\n"
        "        if n != '__init__': run.load_module(kind, n)\n"
        "from mpc_limx_control_tpu_torch.control import rollout, session\n"
        "from mpc_limx_control_tpu_torch import runtime\n")
    assert run.forbidden_loaded(mods) == []
    assert "mpc_limx_control_tpu_torch.control.rollout" in mods


def test_the_reference_loads_nothing_of_the_port():
    mods = _loaded_by(
        "import portbench.reference.tick, portbench.reference.precision\n"
        "import portbench.compare, portbench.work, portbench.trace\n")
    assert run.forbidden_loaded(mods, run.FORBIDDEN_REFERENCE) == []
    assert "portbench.reference.tick" in mods
