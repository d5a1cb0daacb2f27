"""The port's ONNX export (``paddle_tpu_torch.onnx``) against the JAX
package's, on the CPU.

The same layer (the reference's weights crossed with ``set_state_dict``)
is exported by both packages; each file is read back with the reference's
wire reader ``load_model``. The node types, their order, inputs, outputs
and attributes, the graph's inputs and outputs (the recorded values'
names up to the recording program's id), the opset and the initializers
(names, types, shapes and bytes) must equal the reference's.
The graph is also run by a NumPy interpreter against the port's eager
output (fp32 rtol 1e-5, atol 1e-5, as the reference's test holds it).
"""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu import onnx as ref_onnx
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _np_run(model, feeds):
    """A NumPy interpreter for the node types these layers export."""
    env = dict(model["initializers"])
    env.update(feeds)
    for n in model["nodes"]:
        i = [env[k] for k in n["inputs"]]
        t, a = n["op_type"], n["attrs"]
        if t == "MatMul":
            r = i[0] @ i[1]
        elif t == "Gemm":
            r = (i[0].T if a.get("transA") else i[0]) @ \
                (i[1].T if a.get("transB") else i[1])
            r = r + i[2] if len(i) > 2 else r
        elif t == "Add":
            r = i[0] + i[1]
        elif t == "Mul":
            r = i[0] * i[1]
        elif t == "Relu":
            r = np.maximum(i[0], 0)
        elif t == "Softmax":
            e = np.exp(i[0] - i[0].max(-1, keepdims=True))
            r = e / e.sum(-1, keepdims=True)
        elif t == "Reshape":
            r = i[0].reshape([int(d) for d in i[1]])
        elif t == "Transpose":
            r = np.transpose(i[0], a["perm"])
        else:
            raise NotImplementedError(t)
        env[n["outputs"][0]] = r
    return [env[o] for o in model["outputs"]]


def _layers(pkg):
    nn = pkg.nn

    class Net(nn.Layer):
        def forward(self, x):
            return pkg.transpose(pkg.reshape(x, [4, 6]), [1, 0])

    class CNN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2D(1, 4, 3, padding=[1, 2])
            self.pool = nn.MaxPool2D(2)
            self.fc = nn.Linear(4 * 4 * 5, 10)

        def forward(self, x):
            y = pkg.nn.functional.relu(self.conv(x))
            y = self.pool(y)
            return self.fc(pkg.flatten(y, start_axis=1))

    class Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(6, 3)

        def forward(self, x):
            return self.fc(x) * 2.0 + 1.0

    class LN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(6, epsilon=1e-12)

        def forward(self, x):
            return self.ln(x)

    return {
        "mlp": (lambda: nn.Sequential(nn.Linear(8, 16), nn.ReLU(),
                                      nn.Linear(16, 4), nn.Softmax()),
                [2, 8]),
        "reshape_transpose": (Net, [2, 12]),
        "cnn": (CNN, [2, 1, 8, 8]),
        "rank3_linear_and_scalars": (Seq, [2, 5, 6]),
        "layer_norm": (LN, [2, 6]),
    }


def _export(name, tmp_path):
    ref.seed(3)
    make, shape = _layers(ref)[name]
    r = make()
    pmake, _ = _layers(pt)[name]
    p = pmake()
    p.set_state_dict({k: np.array(v.numpy())
                      for k, v in r.state_dict().items()})
    rm = ref_onnx.load_model(ref.onnx.export(
        r, str(tmp_path / "ref"),
        input_spec=[ref.static.InputSpec(shape, "float32")]))
    pm = ref_onnx.load_model(pt.onnx.export(
        p, str(tmp_path / "port"),
        input_spec=[pt.static.InputSpec(shape, "float32")]))
    return p, shape, rm, pm


def _edges(model):
    """The graph's edges renamed in order of first use: the recorded
    values' names carry the id of the program that recorded them, which
    counts the programs each package's process made before."""
    names = {}

    def canon(n):
        return n if n in model["initializers"] else \
            names.setdefault(n, f"e{len(names)}")
    nodes = [([canon(i) for i in n["inputs"]],
              [canon(o) for o in n["outputs"]], n["attrs"])
             for n in model["nodes"]]
    return (nodes, [canon(i) for i in model["inputs"]],
            [canon(o) for o in model["outputs"]])


@pytest.mark.parametrize("name", list(_layers(ref)))
def test_graph_equals_the_reference(name, tmp_path):
    p, shape, rm, pm = _export(name, tmp_path)
    assert [n["op_type"] for n in pm["nodes"]] == \
        [n["op_type"] for n in rm["nodes"]]
    assert _edges(pm) == _edges(rm)
    assert pm["opset"] == rm["opset"]
    assert list(pm["initializers"]) == list(rm["initializers"])
    for k, v in rm["initializers"].items():
        got = pm["initializers"][k]
        assert (got.dtype, got.shape) == (v.dtype, v.shape), k
        assert got.tobytes() == v.tobytes(), k
    assert pm["producer"] == "paddle_tpu_torch"
    if name != "layer_norm":
        x = np.random.RandomState(0).randn(*shape).astype(np.float32)
        if name == "cnn":
            return  # Conv and MaxPool are not in the small interpreter
        (got,) = _np_run(pm, {pm["inputs"][0]: x})
        np.testing.assert_allclose(got, p(pt.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_cnn_pads_order_and_flatten(tmp_path):
    _, _, _, m = _export("cnn", tmp_path)
    conv = [n for n in m["nodes"] if n["op_type"] == "Conv"][0]
    assert conv["attrs"]["pads"] == [1, 2, 1, 2]   # all begins, all ends
    rs = [n for n in m["nodes"] if n["op_type"] == "Reshape"][0]
    assert m["initializers"][rs["inputs"][1]].tolist() == [2, 80]


def test_layer_norm_raises_the_opset(tmp_path):
    _, _, _, m = _export("layer_norm", tmp_path)
    assert m["opset"] >= 17


def test_export_requires_input_spec_and_names_unmapped_ops(tmp_path):
    with pytest.raises(ValueError, match="input_spec"):
        pt.onnx.export(pt.nn.Linear(4, 2), str(tmp_path / "m"))

    class Cum(pt.nn.Layer):
        def forward(self, x):
            return pt.cumsum(x, axis=1)

    with pytest.raises(NotImplementedError, match="cumsum"):
        pt.onnx.export(Cum(), str(tmp_path / "c"),
                       input_spec=[pt.static.InputSpec([2, 3], "float32")])
