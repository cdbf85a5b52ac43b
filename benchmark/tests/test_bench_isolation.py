"""What the benchmark runs loads neither JAX nor the JAX package, compared by
whole top-level module names (the system's package begins with the JAX
package's name); the reference loads nothing of the system either. Each
import runs in a fresh interpreter."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness

ENTRIES = ["benchmark.run", "benchmark.drivers.sample", "benchmark.drivers.serve",
           "benchmark.drivers.train", "benchmark.drivers.train_mesh", "benchmark.loadgen",
           "benchmark.control", "pmhc_tpu_torch.serve", "pmhc_tpu_torch.cli.serve_cli",
           "pmhc_tpu_torch.train", "pmhc_tpu_torch.parallel"]


def loaded(module: str):
    code = f"import sys, json, {module}; print(json.dumps(sorted(sys.modules)))"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ENTRIES)
def test_no_jax(module):
    assert harness.forbidden_modules(loaded(module)) == []


@pytest.mark.parametrize("module", ["benchmark.reference.model", "benchmark.reference.atoms",
                                    "benchmark.reference.check", "benchmark.inputs",
                                    "benchmark.roofline"])
def test_reference_is_plain(module):
    mods = loaded(module)
    assert harness.forbidden_modules(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "pmhc_tpu_torch"]


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["pmhc_tpu_torch.serve", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["pmhc_tpu.ops", "jax._src", "flax"]) == [
        "flax", "jax._src", "pmhc_tpu.ops"]
