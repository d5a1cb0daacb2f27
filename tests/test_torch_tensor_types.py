"""The port's ``framework`` (``save``/``load``/``seed`` and the tensor
types of ``framework/tensor_types.py``) against the JAX package's, on the
CPU: the same numpy inputs through both, results equal (exact: sums of a
few small floats and copies), and each package loads the other's
``paddle.save`` file."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

PKGS = (ref, pt)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _each(fn):
    return [fn(pkg, pkg.framework) for pkg in PKGS]


def test_selected_rows_to_dense():
    v = np.array([[1., 2.], [3., 4.]], np.float32)
    got = _each(lambda pkg, fw: fw.SelectedRows(
        rows=[5, 1], value=pkg.to_tensor(v), height=8))
    assert got[1].shape == got[0].shape == [8, 2]
    np.testing.assert_array_equal(got[1].to_dense().numpy(),
                                  got[0].to_dense().numpy())
    assert "height=8" in repr(got[1])


def test_selected_rows_merge_accumulates_duplicates():
    v = np.array([[1.], [2.], [10.]], np.float32)
    got = _each(lambda pkg, fw: fw.SelectedRows(
        rows=[3, 3, 0], value=pkg.to_tensor(v), height=4).merge())
    assert got[1].rows == got[0].rows == [0, 3]
    np.testing.assert_array_equal(got[1].value.numpy(), got[0].value.numpy())


def test_selected_rows_row_mismatch_raises():
    for pkg, fw in zip(PKGS, (ref.framework, pt.framework)):
        with pytest.raises(ValueError):
            fw.SelectedRows(rows=[0], value=pkg.to_tensor(
                np.zeros((2, 3), np.float32)), height=4)


def test_tensor_array_write_read_length_stack_concat_pop():
    def run(pkg, fw):
        arr = fw.create_array()
        for i in range(3):
            fw.array_write(pkg.to_tensor(np.full((2,), float(i),
                                                 np.float32)), i, arr)
        out = [fw.array_length(arr), fw.array_read(arr, 1).numpy(),
               arr.stack().numpy(), arr.concat(axis=0).numpy()]
        out.append(arr.pop().numpy())
        out.append(len(list(arr)))
        return out

    got, want = _each(run)[::-1]
    assert got[0] == want[0] == 3 and got[-1] == want[-1] == 2
    for g, w in zip(got[1:-1], want[1:-1]):
        np.testing.assert_array_equal(g, w)


def test_string_tensor():
    data = [["Hello ", "World"], ["Foo", " Bar"]]
    got = _each(lambda pkg, fw: fw.StringTensor(data))
    for op in ("lower", "upper", "strip"):
        np.testing.assert_array_equal(getattr(got[1], op)().numpy(),
                                      getattr(got[0], op)().numpy())
    assert got[1].shape == [2, 2] and got[1][1, 0] == "Foo"


@pytest.mark.parametrize("writer,reader", [(ref, pt), (pt, ref), (pt, pt)],
                         ids=["ref_to_port", "port_to_ref", "port_to_port"])
def test_save_load_across_packages(tmp_path, writer, reader):
    writer.seed(4)
    layer = writer.nn.Linear(3, 2)
    state = layer.state_dict()
    state["bf16"] = writer.to_tensor(np.arange(4, dtype=np.float32)) \
        .astype("bfloat16")
    path = str(tmp_path / "sub" / "model.pdparams")
    writer.save({"model": state, "step": 3}, path)
    got = reader.load(path)
    assert got["step"] == 3
    for k, v in state.items():
        assert got["model"][k].dtype.name == v.dtype.name, k
        np.testing.assert_array_equal(got["model"][k].numpy(), v.numpy())
        assert got["model"][k].stop_gradient == v.stop_gradient


def test_seed_makes_the_same_draws():
    pt.framework.seed(7)
    a = pt.randn([3]).numpy()
    pt.framework.seed(7)
    np.testing.assert_array_equal(pt.randn([3]).numpy(), a)
