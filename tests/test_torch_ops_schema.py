"""The port's op schema, generator and registry (``ops/yaml/ops.yaml``,
``ops/yaml/gen.py``, ``ops/generated.py``, ``_core/op_registry.py``), the
counterpart of ``tests/test_op_yaml.py``; the coverage of the reference's
public surface; and the op bodies' host reads.

- Every entry of the port's schema is registered in the port or named in
  ``LATER`` beside the roadmap item that brings it; the two partition
  the schema, and no op of this slice's modules is in ``LATER``.
- Every public callable of ``paddle_tpu`` and every attribute of its
  ``Tensor`` exists in the port, except the names in ``LATER_NAMES``
  (which may only shrink).
- No op body in ``paddle_tpu_torch/ops/`` reads tensor data on the host
  (``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``, ``int(...)`` of
  a call) outside ``HOST_READS``: a shape, axis or count given as a
  tensor, and the data-dependent output lengths.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import op_registry
from paddle_tpu_torch.ops.yaml import gen
from paddle_tpu_torch.testing import op_cases as oc

ROOT = Path(__file__).resolve().parents[1]

_FFT = "ROADMAP §1 item 10: fft and signal"

LATER = dict(
    [(n, _FFT) for n in (
        "fft_fft fft_fft2 fft_fftn fft_fftshift fft_hfft fft_ifft "
        "fft_ifft2 fft_ifftn fft_ifftshift fft_ihfft fft_irfft fft_irfft2 "
        "fft_irfftn fft_rfft fft_rfft2 fft_rfftn signal_frame "
        "signal_overlap_add signal_stft signal_stft_nowin signal_istft "
        "signal_istft_nowin").split()])

_FRAMEWORK = ("ROADMAP §1 items 8 and 10: framework names that are not ops "
              "(hapi's Model, summary and flops; DataParallel; the extra "
              "places)")
LATER_NAMES = {
    # top-level callables
    "Model": _FRAMEWORK, "summary": _FRAMEWORK,
    "flops": _FRAMEWORK,
    "TPUPlace": _FRAMEWORK, "CustomPlace": _FRAMEWORK,
}
_INTERNAL = ("the JAX package's lazy-executor internals, which the port's "
             "torch payload has no counterpart of")
TENSOR_INTERNALS = {n: _INTERNAL for n in (
    "__jax_array__", "_autograd_meta", "_dist_attr", "_inplace_version",
    "_meta_aval", "_payload", "_replace_value_inplace", "_stop_gradient",
    "_value")}

# the reference's modules of this slice, by the schema's section names
SLICE_SECTIONS = ("ops._helper", "ops.creation", "ops.extra",
                  "ops.indexing", "ops.linalg", "ops.manipulation",
                  "ops.math", "ops.math_ext", "ops.reduction", "ops.search",
                  "ops.parity", "linalg")

# (file under paddle_tpu_torch/ops, function): the host reads allowed
HOST_READS = {
    ("creation.py", "_shape"): "a shape given as a Tensor",
    ("creation.py", "full"): "a fill value given as a Tensor",
    ("manipulation.py", "_ints"): "a shape given as a Tensor",
    ("manipulation.py", "concat"): "an axis given as a Tensor",
    ("manipulation.py", "repeat_interleave"):
        "repeats given as a Tensor: the output's length",
    ("manipulation.py", "pad"): "pads given as a Tensor",
    ("reduction.py", "_axes"): "axes given as a Tensor",
    ("search.py", "gather"): "an axis given as a Tensor",
    ("search.py", "topk"): "k given as a Tensor",
    ("extra.py", "bincount"): "the output's length, max(x) + 1",
    ("segment.py", "_num_segments"):
        "the output's length, max(segment_ids) + 1",
    ("parity.py", "sequence_mask"): "maxlen None: the longest length",
    ("__init__.py", "<module>"): "Tensor.cpu itself",
}
# beside them, outside ``ops/``: the calls whose output length depends on
# the data (a sync with no host-read call in the source), by (file under
# paddle_tpu_torch, function)
DATA_DEPENDENT_SYNCS = {
    ("vision/ops.py", "nms"): "the kept boxes' count (torch.nonzero), "
                              "which also says whether the sweep settled",
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _sections():
    """Schema op name -> the section (registering module) it sits in."""
    out, sec = {}, "head"
    with open(op_registry.SCHEMA) as f:
        for line in f:
            line = line.strip()
            if line.startswith("# ---- "):
                sec = line[len("# ---- "):].split()[0]
            elif line.startswith("- op:"):
                out[line.split(":", 1)[1].split("#")[0].strip()] = sec
    return out


class TestSchema:
    def test_loads_and_validates_clean(self):
        entries = gen.load_schema()
        assert len(entries) == 415
        assert gen.validate() == []
        ported = {n: e for n, e in entries.items() if n not in LATER}
        assert gen.validate(ported) == []

    def test_matmul_entry_shape(self):
        e = gen.load_schema()["matmul"]
        assert e.tensor_args == [("x", ""), ("y", "")]
        assert [a[0] for a in e.attrs] == ["transpose_x", "transpose_y"]
        assert e.spmd_rule == "matmul"
        assert e.n_outputs == 1

    def test_validate_catches_unknown_op(self):
        e = gen.OpEntry("definitely_not_an_op")
        assert gen.validate({"definitely_not_an_op": e})

    def test_validate_catches_arity_mismatch(self):
        e = gen.OpEntry("matmul")
        e.n_outputs = 2
        assert any("multi_output" in p for p in gen.validate({"matmul": e}))

    def test_validate_catches_bad_attr_name(self):
        e = gen.load_schema()["clip"]
        e.attrs = [("minimum", "float", None), ("hi", "float", None)]
        assert any("minimum" in p for p in gen.validate({"clip": e}))

    def test_validate_catches_missing_varargs(self):
        e = gen.load_schema()["clip"]
        e.tensor_args = [("xs", "[]")]
        assert any("variadic" in p for p in gen.validate({"clip": e}))

    def test_spmd_rule_is_read_and_kept(self):
        entries = gen.load_schema()
        assert entries["softmax"].spmd_rule == "softmax"
        assert sum(e.spmd_rule is not None for e in entries.values()) == 107

    def test_schema_is_the_ports_own_copy(self):
        """The port reads its own file; it names every entry of the
        reference's, signature for signature."""
        from paddle_tpu.ops.yaml import gen as ref_gen
        mine, theirs = gen.load_schema(), ref_gen.load_schema()
        assert list(mine) == list(theirs)
        for n in mine:
            assert mine[n].tensor_args == theirs[n].tensor_args, n
            assert mine[n].attrs == theirs[n].attrs, n
            assert mine[n].n_outputs == theirs[n].n_outputs, n
        assert Path(op_registry.SCHEMA).resolve().parent == \
            ROOT / "paddle_tpu_torch" / "ops" / "yaml"

    def test_registered_and_later_partition_the_schema(self):
        entries = set(gen.load_schema())
        registered = set(op_registry.all_ops())
        assert not set(LATER) & registered, set(LATER) & registered
        assert set(gen.unported()) == set(LATER)
        assert registered | set(LATER) == entries | {
            n for n, op in op_registry.all_ops().items() if op.custom}

    def test_no_op_of_this_slice_is_later(self):
        sections = _sections()
        later_in_slice = sorted(n for n in LATER
                                if sections[n] in SLICE_SECTIONS)
        assert not later_in_slice
        for n, item in LATER.items():
            assert item.startswith("ROADMAP §1"), (n, item)

    def test_every_registered_op_has_a_case(self):
        """Each registered op is driven by a case of the op tables
        (random ops: by the distribution tests)."""
        missing = set(op_registry.all_ops()) - oc.covered_ops() - set(
            oc.RANDOM_OPS)
        assert not missing, sorted(missing)


class TestGenerated:
    def test_generated_matmul_matches_handwritten(self):
        from paddle_tpu_torch.ops import generated
        rng = np.random.RandomState(0)
        x = pt.to_tensor(rng.randn(3, 4).astype(np.float32))
        y = pt.to_tensor(rng.randn(4, 2).astype(np.float32))
        np.testing.assert_array_equal(generated.matmul(x, y).numpy(),
                                      pt.matmul(x, y).numpy())
        np.testing.assert_allclose(
            generated.matmul(y, x, transpose_x=True,
                             transpose_y=True).numpy(),
            pt.matmul(x, y).numpy().T, rtol=1e-6)

    def test_generated_multi_output(self):
        from paddle_tpu_torch.ops import generated
        p, ids = generated.top_p_sampling(
            pt.to_tensor(np.array([[0.9, 0.1]], np.float32)),
            pt.to_tensor(np.array([0.5], np.float32)), seed=3)
        assert int(ids.numpy()[0, 0]) == 0 and ids.dtype == "int64"

    def test_required_attrs_not_fabricated(self):
        from paddle_tpu_torch.ops import generated
        x = pt.to_tensor(np.array([1., -2., 3.], np.float32))
        with pytest.raises(TypeError):
            generated.clip(x)
        np.testing.assert_array_equal(
            generated.clip(x, lo=-1.0, hi=1.0).numpy(), [1., -1., 1.])
        with pytest.raises(TypeError):
            generated.top_p_sampling(
                pt.to_tensor(np.ones((1, 2), np.float32)),
                pt.to_tensor(np.ones((1,), np.float32)))

    def test_generated_grad_flows(self):
        from paddle_tpu_torch.ops import generated
        x = pt.to_tensor(np.ones((2, 3), np.float32), stop_gradient=False)
        generated.gelu(x).sum().backward()
        assert x.grad is not None

    def test_regeneration_is_deterministic(self):
        assert gen.generate_wrappers() == gen.generate_wrappers()

    def test_emitted_file_in_sync_with_schema(self):
        path = ROOT / "paddle_tpu_torch" / "ops" / "generated.py"
        assert path.read_text() == gen.generate_wrappers()

    def test_generated_surface_is_complete(self):
        from paddle_tpu_torch.ops import generated
        for name in op_registry.all_ops():
            if not op_registry.get_op(name).custom:
                assert hasattr(generated, name), name

    def test_generated_calls_go_through_dispatch(self, monkeypatch):
        """A by-name call reaches dispatch.apply under the op's name, so
        AMP's per-name rules apply to it."""
        from paddle_tpu_torch._core import dispatch
        from paddle_tpu_torch.ops import generated
        seen = []
        monkeypatch.setattr(dispatch, "AMP_HOOK",
                            lambda name, args: seen.append(name) or args)
        generated.exp(pt.to_tensor(np.ones(2, np.float32)))
        assert seen == ["exp"]


class TestRegistry:
    def test_register_without_schema_entry_raises(self):
        with pytest.raises(ValueError, match="system of record"):
            op_registry.register_op("op_nobody_declared", lambda x: x)

    def test_duplicate_registration_raises(self):
        with pytest.raises(ValueError, match="already registered"):
            op_registry.register_op("exp", lambda x: x)

    def test_custom_escape_hatch(self):
        op_registry.register_op("oot_probe_op", lambda x: x + 1.0,
                                custom=True)
        try:
            x = pt.to_tensor(np.zeros((2,), np.float32))
            np.testing.assert_array_equal(
                op_registry.call("oot_probe_op", x).numpy(), [1.0, 1.0])
            np.testing.assert_array_equal(
                pt.apply("oot_probe_op", x).numpy(), [1.0, 1.0])
            assert "oot_probe_op" not in gen.unported()
        finally:
            op_registry._OPS.pop("oot_probe_op", None)

    def test_multi_output_flag(self):
        assert op_registry.get_op("svd_").multi_output
        assert not op_registry.get_op("matmul").multi_output


class TestCoverage:
    def test_every_public_callable_exists_in_the_port(self):
        names = [n for n in dir(ref) if not n.startswith("_")
                 and callable(getattr(ref, n))]
        missing = sorted(n for n in names if not hasattr(pt, n)
                         and n not in LATER_NAMES)
        assert not missing, missing

    def test_every_tensor_attribute_exists_in_the_port(self):
        missing = sorted(n for n in dir(ref.Tensor)
                         if not hasattr(pt.Tensor, n)
                         and n not in LATER_NAMES
                         and n not in TENSOR_INTERNALS)
        assert not missing, missing

    def test_later_names_are_still_missing(self):
        """A name the port gained leaves the list (it may only shrink)."""
        stale = [n for n in LATER_NAMES
                 if hasattr(pt, n) or hasattr(pt.Tensor, n)]
        assert not stale, stale

    def test_linalg_namespace(self):
        for n in dir(ref.linalg):
            if not n.startswith("_") and callable(getattr(ref.linalg, n)) \
                    and n not in ("apply", "register_op", "jnp"):
                assert hasattr(pt.linalg, n), n


def _host_reads(path):
    """(function, line) of every host read in a file: a call of .cpu(),
    .numpy(), .tolist() or .item(), or int()/float() of a call."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Call):
                f = child.func
                if isinstance(f, ast.Attribute) and f.attr in (
                        "cpu", "numpy", "tolist", "item"):
                    out.append((fn, child.lineno))
                elif isinstance(f, ast.Name) and f.id in ("int", "float") \
                        and child.args and isinstance(child.args[0],
                                                      ast.Call):
                    out.append((fn, child.lineno))
            visit(child, name)
    visit(tree, "<module>")
    return out


def test_op_bodies_read_no_data_on_the_host():
    ops = ROOT / "paddle_tpu_torch" / "ops"
    bad = []
    for path in sorted(ops.glob("*.py")):
        for fn, line in _host_reads(path):
            if (path.name, fn) not in HOST_READS:
                bad.append(f"{path.name}:{line} in {fn}")
    assert not bad, bad


def test_vision_ops_sync_only_where_listed():
    """``vision/ops.py`` makes no host-read call, and its one
    data-dependent call (``nonzero``) sits where
    ``DATA_DEPENDENT_SYNCS`` says."""
    path = ROOT / "paddle_tpu_torch" / "vision" / "ops.py"
    assert _host_reads(path) == []
    tree = ast.parse(path.read_text())
    found = {("vision/ops.py", fn.name) for fn in ast.walk(tree)
             if isinstance(fn, ast.FunctionDef)
             for node in ast.walk(fn) if isinstance(node, ast.Attribute)
             and node.attr in ("nonzero", "masked_select", "unique")}
    assert found == set(DATA_DEPENDENT_SYNCS), found


def test_host_read_rule_catches_a_read(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("def f(t):\n    return t.cpu().numpy()\n\ndef g(t):\n"
                 "    return int(t.max())\n")
    assert sorted(fn for fn, _ in _host_reads(p)) == ["f", "f", "g"]


def test_host_read_list_names_only_reads_that_exist():
    ops = ROOT / "paddle_tpu_torch" / "ops"
    found = {(p.name, fn) for p in ops.glob("*.py")
             for fn, _ in _host_reads(p)}
    assert set(HOST_READS) <= found, set(HOST_READS) - found
