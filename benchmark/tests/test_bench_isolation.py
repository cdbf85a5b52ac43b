"""What the benchmark runs loads neither JAX nor the JAX package, compared by
whole top-level module names (the system's package begins with the JAX
package's name); the reference loads nothing of the system either. Each
import runs in a fresh interpreter. The modules are found by file: every
driver, reader, reference package and roofline, so a new one is checked
without an edit here."""

import glob
import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


def modules(pattern: str):
    """Dotted names of the benchmark's modules whose files match ``pattern``
    (relative to ``benchmark/``); a package by its own name."""
    out = []
    for path in sorted(glob.glob(os.path.join(harness.HERE, pattern), recursive=True)):
        rel = os.path.relpath(path, harness.ROOT)[:-3].split(os.sep)
        out.append(".".join(rel[:-1] if rel[-1] == "__init__" else rel))
    return sorted(set(out))


DRIVERS = [m for m in modules("drivers/*.py") if m != "benchmark.drivers"]
ENTRIES = ["benchmark.run", "benchmark.loadgen", "benchmark.control", *DRIVERS,
           "pmhc_tpu_torch.serve", "pmhc_tpu_torch.cli.serve_cli", "pmhc_tpu_torch.train",
           "pmhc_tpu_torch.parallel"]
PLAIN = [*modules("reference*/**/*.py"), "benchmark.inputs", *modules("roofline*.py")]
READERS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(harness.HERE, "metrics", "*.py")))


def loaded(code: str):
    """The modules loaded after ``code`` ran in a fresh interpreter."""
    code += "\nimport sys, json; print(json.dumps(sorted(sys.modules)))"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, env=env, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", ENTRIES)
def test_no_jax(module):
    assert harness.forbidden_modules(loaded(f"import {module}")) == []


@pytest.mark.parametrize("metric", READERS)
def test_reader_loads_no_jax(metric):
    code = ("import importlib.util, os\nfrom benchmark import harness\n"
            f"p = os.path.join(harness.HERE, 'metrics', {metric + '.py'!r})\n"
            f"s = importlib.util.spec_from_file_location('benchmark.metrics.{metric}', p)\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))")
    assert harness.forbidden_modules(loaded(code)) == []


def test_modules_are_found_by_file():
    assert {"benchmark.drivers.sample", "benchmark.drivers.train_mesh"} <= set(DRIVERS)
    assert {"benchmark.reference", "benchmark.reference.check", "benchmark.roofline"} <= set(
        PLAIN)
    assert "mfu.train" in READERS


@pytest.mark.parametrize("module", PLAIN)
def test_reference_is_plain(module):
    mods = loaded(f"import {module}")
    assert harness.forbidden_modules(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "pmhc_tpu_torch"]


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(["pmhc_tpu_torch.serve", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(["pmhc_tpu.ops", "jax._src", "flax"]) == [
        "flax", "jax._src", "pmhc_tpu.ops"]


def plant_in_rank_1():
    """A mesh rank's ``prepare``: rank 1 loads a module of the JAX package."""
    import types

    import torch.distributed as dist

    if dist.get_rank() == 1:
        sys.modules["pmhc_tpu.models"] = types.ModuleType("pmhc_tpu.models")


def test_a_module_loaded_in_a_rank_refuses_the_result():
    """The ranks of a mesh cell run its window and check in processes of
    their own: what one of them loads reaches the result's gate."""
    import time

    from benchmark import run
    from benchmark.tests.tiny import tiny_cell

    cell = tiny_cell("ff32.train.dp4")
    rec = harness.driver("train_mesh").run(cell, seed=2 ** 31 + 37, seconds=0.5, trace=False,
                                           t0=time.monotonic(), device="cpu",
                                           prepare=plant_in_rank_1)
    assert rec.forbidden == ["pmhc_tpu.models"]
    assert "pmhc_tpu.models" in run.forbidden(rec)
