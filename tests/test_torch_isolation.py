"""The port stands alone: nothing under ``src/repro_torch/``, nor
``chip_smoke.py``, imports ``jax``, ``ml_dtypes`` or ``repro``; its CUDA
entry points raise on a host they cannot reach instead of carrying on on
the CPU; its kernels build for ``sm_90a`` from its own ``csrc/`` only."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_nor_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    bad = [(f.relative_to(ROOT).as_posix(), name) for f in files for name in _imports(f)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("module", ["serve/__init__.py", "serve/table_manager.py",
                                    "core/pruning.py", "testing/__init__.py",
                                    "testing/faults.py", "testing/thresholds.py",
                                    "kernels/lasso_prune.py"])
def test_adaptation_modules_import_no_jax_nor_repro(module):
    path = PORT / module
    assert path.exists()
    bad = [name for name in _imports(path) if name.split(".")[0] in FORBIDDEN]
    assert not bad, (module, bad)


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the cuda device is reachable here")


def test_entry_points_default_to_cuda_and_raise_without_it():
    _no_cuda()
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.core import dssoftmax
    from repro_torch.models import build

    cfg = reduce_config(get_config("qwen2-1.5b"))
    with pytest.raises(RuntimeError, match="cuda"):
        build(cfg)
    h = torch.zeros(2, 8)
    table = dssoftmax.ServeTable(ids=torch.zeros(4, 8, dtype=torch.int32),
                                 weights=torch.zeros(4, 8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        dssoftmax.serve_topk(torch.zeros(4, 8), table, h, 2)
    import numpy as np

    from repro_torch.convert import head_from_jax

    with pytest.raises(RuntimeError, match="cuda"):
        head_from_jax({"gate": np.zeros((4, 8), np.float32),
                       "experts": np.zeros((4, 16, 8), np.float32)}, np.ones((4, 16), bool))


@pytest.mark.parametrize("name", ["gate_top1", "dss_topk_grouped", "dss_topk_fused",
                                  "dss_topk_kernel", "lasso_prune"])
def test_kernel_wrappers_raise_on_an_unreachable_device(name):
    """CPU tensors handed to a wrapper asked for CUDA (the default) raise;
    they never fall back to the plain version."""
    from repro_torch.kernels import ops

    fn = getattr(ops, name)
    gate, h = torch.zeros(4, 8), torch.zeros(2, 8)
    w, ids = torch.zeros(4, 16, 8), torch.zeros(4, 16, dtype=torch.int32)
    args = {"gate_top1": (gate, h),
            "dss_topk_grouped": (w, ids, torch.zeros(4, 2, 8), torch.zeros(4, 2), 2),
            "dss_topk_fused": (gate, w, ids, h, 2),
            "dss_topk_kernel": (w, ids, h, torch.zeros(2, dtype=torch.int32), 2),
            "lasso_prune": (w, torch.ones(4, 16, dtype=torch.bool), 0.5)}[name]
    before = fn.launches
    with pytest.raises((RuntimeError, ValueError)):
        fn(*args)
    with pytest.raises(ValueError):
        fn(*args, device="meta")
    assert fn.launches == before


def test_build_targets_sm90a_from_port_sources_only():
    from repro_torch.kernels import _build

    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.CSRC == PORT / "csrc"
    for name in _build.SOURCES:
        srcs = _build._source_files(name)
        assert srcs and all(p.parent == PORT / "csrc" for p in srcs)
        assert srcs[0].name == f"{name}.cu" and srcs[0].exists()
        assert set(_build.SIGNATURES) == set(_build.SOURCES)
    # the build lands in a directory .gitignore lists
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    # each kernel source names the TPU kernel it replaces
    for name in _build.SOURCES:
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{name}.py" in text and "Bound on this card" in text
