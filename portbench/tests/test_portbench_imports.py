"""Nothing the benchmark runs loads jax or the JAX package, and the
reference loads nothing of the port: top-level module names, compared
whole (the port's name begins with the JAX package's)."""

import json
import subprocess
import sys

import portbench_tiny
from portbench.harness.guard import forbidden_loaded

ROOT = portbench_tiny.ROOT


def loaded_after(code: str) -> set[str]:
    """The top-level names of the modules a fresh interpreter holds after
    running `code` from the repository root."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_guard_compares_whole_top_level_names():
    assert forbidden_loaded({"hackathonopticalflow_tpu_torch": 0, "hackathonopticalflow_tpu_torch.ops": 0}) == []
    assert forbidden_loaded({"hackathonopticalflow_tpu.ops.lk": 0, "jaxlib": 0, "jaxtyping": 0}) == [
        "hackathonopticalflow_tpu.ops.lk", "jaxlib"]


def test_the_reference_loads_nothing_of_the_port_or_jax():
    names = loaded_after("import portbench.reference.lk_grid, portbench.reference.farneback")
    assert "hackathonopticalflow_tpu_torch" not in names
    assert not names & {"jax", "jaxlib", "flax", "hackathonopticalflow_tpu"}


def test_a_run_loads_the_port_and_never_jax():
    code = ("import sys; sys.path.insert(0, 'portbench/tests')\n"
            "import portbench_tiny\n"
            "out = portbench_tiny.run_tiny('pathfinder-1080p.review', seconds=0.3)\n"
            "assert out['correct'], out['checks']\n"
            "import glob, portbench.harness.spec as spec\n"
            "for p in glob.glob('portbench/metrics/*.py') + glob.glob('portbench/entries/*.py'):\n"
            "    spec.load_module(spec.Path(p).resolve())\n")
    names = loaded_after(code)
    assert "hackathonopticalflow_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "hackathonopticalflow_tpu"}
