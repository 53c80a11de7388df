"""The port stands alone: tpusppy_torch loads neither jax nor tpusppy, and its
entry points run on CUDA unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "tpusppy_torch"


def _modules():
    out = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_importing_every_module_loads_no_jax_and_no_tpusppy():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'tpusppy' or "
        "m.startswith('tpusppy.'))\n"
        "print(repr(bad))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_file_imports_jax_or_tpusppy():
    offenders = []
    for p in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "tpusppy"):
                    offenders.append(f"{p.relative_to(REPO)}: {name}")
    assert offenders == []


@pytest.fixture
def no_gpu(monkeypatch):
    """The entry points as they behave on a machine without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_ph_without_a_device_raises_when_no_gpu(no_gpu):
    from tpusppy_torch.models import farmer
    from tpusppy_torch.opt.ph import PH

    names = farmer.scenario_names_creator(3)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH(opts, names, farmer.scenario_creator,
           scenario_creator_kwargs={"num_scens": 3})
    ph = PH(dict(opts, device="cpu"), names, farmer.scenario_creator,
            scenario_creator_kwargs={"num_scens": 3})
    assert ph.device.type == "cpu"


def test_solver_device_follows_argument_then_tensors(no_gpu):
    from tpusppy_torch.solvers import admm

    rng = np.random.RandomState(0)
    S, m, n = 2, 3, 4
    A = rng.randn(S, m, n)
    args = (rng.randn(S, n), np.zeros((S, n)), A, -np.ones((S, m)),
            np.ones((S, m)), np.zeros((S, n)), np.ones((S, n)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        admm.solve_batch(*args)
    sol = admm.solve_batch(*args, device="cpu")
    assert sol.x.device.type == "cpu"
    targs = (args[0], args[1], torch.as_tensor(A)) + args[3:]
    assert admm.solve_batch(*targs).x.device.type == "cpu"


def test_bundles_module_is_covered_and_bundled_ph_needs_a_device(no_gpu):
    """The bundling module is among those the checks above import, and a
    bundled, bucketed PH asks for a device as every entry point does."""
    from tpusppy_torch.models import farmer
    from tpusppy_torch.opt.ph import PH

    assert "tpusppy_torch.bundles" in _modules()
    names = farmer.scenario_names_creator(7)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2, "bundles_per_rank": 3,
            "shape_buckets": True, "shape_bucket_quantum": 1}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PH(opts, names, farmer.scenario_creator,
           scenario_creator_kwargs={"num_scens": 7})
    ph = PH(dict(opts, device="cpu"), names, farmer.scenario_creator,
            scenario_creator_kwargs={"num_scens": 7})
    assert len(ph.batch.buckets) == 2 and ph.device.type == "cpu"


def test_batched_runner_needs_a_device(no_gpu):
    """The tenant window's runner asks for a device as every entry point
    does; the CPU is taken only when asked for."""
    from tpusppy_torch.models import farmer
    from tpusppy_torch.service import ingest
    from tpusppy_torch.service.batching import BatchedFamilyRunner

    names = farmer.scenario_names_creator(3)
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2, "in_wheel_bounds": True}
    canon = ingest(names, farmer.scenario_creator, {"num_scens": 3},
                   options=opts)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedFamilyRunner(canon, opts, k_slots=2)
    runner = BatchedFamilyRunner(canon, dict(opts, device="cpu"), k_slots=2)
    assert runner.device.type == "cpu"
