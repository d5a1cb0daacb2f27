"""Rules of the PyTorch port, as tests.

- ``paddle_tpu_torch/`` (``entry.py`` and ``testing/dist.py`` among
  it), ``chip_smoke.py``, ``chip_fwd_wide.py``, ``chip_profiler_probe.py``,
  ``chip_nccl_probe.py``, ``chip_bert_turns.py``,
  ``chip_compile_witness.py`` and ``chip_runtime_probe.py`` import neither
  JAX nor the JAX package (``paddle_tpu``), not even a module of it that
  does not import JAX: the port keeps its own copy of what it needs. Nor
  do the tests' rank-function modules (``tests/torch_*_ranks.py``,
  ``tests/torch_fleet_workers.py``), which the spawned ranks import.
- The port's entry points run on the card unless the caller asks for the
  CPU; with no card they raise instead of carrying on on the CPU.
- The port's parameter tree and weight-decay mask are the reference's, key
  for key, so state moves between the two packages leaf for leaf.
"""
import ast
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.models import gpt as pt_gpt
from paddle_tpu_torch.models.convert import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "chip_fwd_wide.py",
    ROOT / "chip_profiler_probe.py", ROOT / "chip_nccl_probe.py",
    ROOT / "chip_bert_turns.py", ROOT / "chip_compile_witness.py",
    ROOT / "chip_runtime_probe.py"] + [
    ROOT / "tests" / name for name in (
        "torch_comm_ranks.py", "torch_dist_ranks.py",
        "torch_fleet_workers.py")]


def _imported_modules(path: Path):
    """Absolute names of every module a file imports (relative imports
    resolved against its package)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    rel = path.relative_to(ROOT).with_suffix("")
    package = list(rel.parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module
            yield mod
            for alias in node.names:
                yield f"{mod}.{alias.name}"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "paddle_tpu")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_no_reference(path):
    assert path.exists(), path
    bad = sorted({m for m in _imported_modules(path) if _forbidden(m)})
    assert not bad, f"{path.name} imports {bad}"


def test_import_rule_covers_the_entry_points_and_the_rank_harness():
    """``entry.py`` (the counterpart of ``__graft_entry__.py``) and
    ``testing/dist.py`` (whose spawned ranks must never import JAX) are
    among the files the rule walks."""
    for rel in ("paddle_tpu_torch/entry.py",
                "paddle_tpu_torch/testing/dist.py", "chip_nccl_probe.py",
                "chip_bert_turns.py", "chip_compile_witness.py",
                "chip_runtime_probe.py"):
        assert ROOT / rel in PORT_FILES, rel


def test_import_rule_catches_a_reference_import():
    """The walk above sees both spellings the rule forbids."""
    src = ROOT / "paddle_tpu_torch" / "models" / "gpt.py"
    names = set(_imported_modules(src))
    assert "paddle_tpu_torch.ops.cuda.flash_attention" in names
    assert not any(_forbidden(n) for n in names)
    tree = ast.parse("from paddle_tpu.models import gpt\nimport jax.numpy")
    found = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    found |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)}
    assert all(_forbidden(n) for n in found)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be "
                    "checked here")


def test_default_device_raises_without_card():
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_build_train_step_without_device_raises_without_card():
    _no_card()
    cfg = pt_gpt.GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                           num_heads=2, max_position_embeddings=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_gpt.build_train_step(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_gpt.init_gpt_params(cfg)


def test_param_tree_matches_reference():
    kw = dict(vocab_size=96, hidden_size=32, num_layers=3, num_heads=2,
              max_position_embeddings=128)
    for dtype in ("float32", "bfloat16"):
        ref = jax.device_get(ref_gpt.init_gpt_params(
            ref_gpt.GPTConfig(dtype=dtype, **kw), seed=0))
        port = pt_gpt.init_gpt_params(pt_gpt.GPTConfig(dtype=dtype, **kw),
                                      seed=0, device="cpu")
        ref_paths = jax.tree_util.tree_flatten_with_path(ref)[0]
        port_paths = jax.tree_util.tree_flatten_with_path(port)[0]
        assert [p for p, _ in ref_paths] == [p for p, _ in port_paths]
        for (path, a), (_, t) in zip(ref_paths, port_paths):
            assert tuple(a.shape) == tuple(t.shape), path
            assert str(t.dtype) == f"torch.{np.dtype(a.dtype).name}", path
            # same distribution, not the same draw: equal stds
            std = float(a.astype(np.float32).std())
            if std > 0:
                assert abs(float(t.float().std()) / std - 1) < 0.2, path
            else:
                assert torch.equal(t, params_from_numpy(a, "cpu")), path


def test_weight_decay_mask_matches_reference(monkeypatch):
    """The reference builds its mask inside ``build_train_step``; catch it
    on its way to the trainer."""
    import paddle_tpu.models.trainer as ref_trainer
    seen = {}

    def capture(loss_fn, init_fn, specs, wd_mask, **kw):
        seen["mask"] = wd_mask
        return None, None

    monkeypatch.setattr(ref_trainer, "build_adamw_train_step", capture)
    ref_gpt.build_train_step(ref_gpt.GPTConfig(
        vocab_size=64, hidden_size=32, num_layers=1, num_heads=2))
    assert seen["mask"] == pt_gpt.WD_MASK


def test_convert_keeps_bf16_exact():
    import ml_dtypes
    vals = np.array([1.0, -2.5, 3.140625, 1e-3, 65280.0], np.float32)
    arr = vals.astype(ml_dtypes.bfloat16)
    t = params_from_numpy({"w": arr}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), arr.astype(np.float32))
