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
                                    "kernels/lasso_prune.py", "serve/paged_cache.py",
                                    "kernels/flash_attention.py", "models/layers.py",
                                    "models/transformer.py", "models/model_zoo.py",
                                    "train/serve.py", "optim/adam.py", "optim/clip.py",
                                    "optim/schedules.py", "train/train_step.py",
                                    "train/trainer.py", "checkpoint/checkpointer.py",
                                    "checkpoint/manager.py", "data/synthetic.py",
                                    "data/pipeline.py", "launch/train.py", "core/losses.py",
                                    "core/mitosis.py", "utils/tree.py", "utils/logging.py",
                                    "launch/serve.py", "configs/__init__.py",
                                    "configs/llama3_2_3b.py", "configs/granite_20b.py",
                                    "configs/deepseek_67b.py", "convert.py", "models/moe.py",
                                    "configs/olmoe_1b_7b.py", "configs/qwen3_moe_235b.py",
                                    "configs/internvl2_26b.py", "configs/base.py",
                                    "models/mamba2.py", "models/hybrid.py",
                                    "configs/mamba2_130m.py", "configs/zamba2_7b.py",
                                    "models/encdec.py", "configs/whisper_base.py",
                                    "configs/paper_lm.py", "configs/shapes.py",
                                    "core/metrics.py", "core/analysis.py",
                                    "core/baselines.py", "utils/timing.py",
                                    "distributed/__init__.py", "distributed/sharding.py",
                                    "launch/mesh.py", "optim/compression.py",
                                    "optim/__init__.py", "launch/dryrun.py",
                                    "distributed/hlo_analysis.py",
                                    "distributed/roofline.py", "device.py",
                                    "testing/mesh_rows.py"])
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

    for arch in ("qwen2-1.5b", "mamba2-130m", "zamba2-7b", "whisper-base", "paper-envi"):
        with pytest.raises(RuntimeError, match="cuda"):
            build(reduce_config(get_config(arch)))
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
                                  "dss_topk_kernel", "lasso_prune", "flash_attention"])
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
            "lasso_prune": (w, torch.ones(4, 16, dtype=torch.bool), 0.5),
            "flash_attention": (torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16),
                                torch.zeros(1, 2, 8, 16))}[name]
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
        # every source has its own entry point; any other entry point lives
        # in a source's library
        assert set(_build.SOURCES) <= set(_build.SIGNATURES)
        assert {_build.ENTRY_LIBRARY.get(e, e) for e in _build.SIGNATURES} == set(_build.SOURCES)
    # the build lands in a directory .gitignore lists
    assert _build.BUILD_DIR.relative_to(ROOT).parts[0] == "build"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    # each kernel source names the TPU kernel it replaces
    for name in _build.SOURCES:
        text = (PORT / "csrc" / f"{name}.cu").read_text()
        assert f"src/repro/kernels/{name}.py" in text and "Bound on this card" in text
