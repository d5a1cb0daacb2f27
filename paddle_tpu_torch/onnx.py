"""paddle.onnx: ONNX export, the counterpart of ``paddle_tpu/onnx.py``.

Upstream Paddle exports through paddle2onnx; this package ships its own
serializer: the model is recorded into a program
(``paddle_tpu_torch.static``), each recorded op maps to an ONNX node, and
the ModelProto is hand-encoded in protobuf wire format (onnx.proto schema
field numbers), with no dependency on the ``onnx`` package. A wire reader
(``load_model``) round-trip-validates the bytes and feeds the tests.

Op coverage targets the deploy-relevant families: Gemm/MatMul, Conv,
Relu/Sigmoid/Tanh/Softmax/Erf, elementwise, MaxPool/AveragePool/
GlobalAveragePool, Reshape/Transpose/Concat/Flatten, BatchNorm/
LayerNorm, ReduceMean/Sum. Unmapped ops raise with the op name so users
know exactly what's missing (paddle2onnx behavior).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

__all__ = ["export", "load_model"]

# ------------------------------------------------------------------ wire

_TENSORPROTO_DTYPE = {"float32": 1, "uint8": 2, "int8": 3, "int32": 6,
                      "int64": 7, "bool": 9, "float16": 10, "float64": 11,
                      "bfloat16": 16}


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode())


def _int_field(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _float_field(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


# ---------------------------------------------------------- proto pieces
# field numbers from onnx.proto: ModelProto{ir_version=1, opset_import=8,
# producer_name=2, graph=7}; GraphProto{node=1, name=2, initializer=5,
# input=11, output=12}; NodeProto{input=1, output=2, name=3, op_type=4,
# attribute=5}; AttributeProto{name=1, f=2, i=3, s=4, t=5, floats=7,
# ints=8, type=20}; TensorProto{dims=1, data_type=2, raw_data=9, name=8};
# ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
# TypeProto.Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
# Dimension{dim_value=1, dim_param=2}; OperatorSetIdProto{domain=1,
# version=2}


def _attr(name: str, value) -> bytes:
    out = _str_field(1, name)
    if isinstance(value, float):
        out += _float_field(2, value) + _int_field(20, 1)       # FLOAT
    elif isinstance(value, bool) or isinstance(value, int):
        out += _int_field(3, int(value)) + _int_field(20, 2)    # INT
    elif isinstance(value, str):
        out += _len_field(4, value.encode()) + _int_field(20, 3)
    elif isinstance(value, np.ndarray):
        out += _len_field(5, _tensor(value, "")) + _int_field(20, 4)
    elif isinstance(value, (list, tuple)):
        if value and isinstance(value[0], float):
            for v in value:
                out += _float_field(7, v)
            out += _int_field(20, 6)                            # FLOATS
        else:
            for v in value:
                out += _int_field(8, int(v))
            out += _int_field(20, 7)                            # INTS
    else:
        raise TypeError(f"unsupported attribute type: {type(value)}")
    return out


def _tensor(arr: np.ndarray, name: str) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += _int_field(1, d)
    out += _int_field(2, _TENSORPROTO_DTYPE[arr.dtype.name])
    if name:
        out += _str_field(8, name)
    out += _len_field(9, arr.tobytes())
    return out


def _value_info(name: str, shape: Sequence, dtype: str) -> bytes:
    dims = b""
    for d in shape:
        if d in (None, -1):
            dims += _len_field(1, _str_field(2, "batch"))
        else:
            dims += _len_field(1, _int_field(1, int(d)))
    tensor_type = (_int_field(1, _TENSORPROTO_DTYPE[dtype])
                   + _len_field(2, dims))
    return (_str_field(1, name)
            + _len_field(2, _len_field(1, tensor_type)))


def _node(op_type: str, inputs: List[str], outputs: List[str],
          name: str, attrs: Dict[str, Any]) -> bytes:
    out = b""
    for i in inputs:
        out += _str_field(1, i)
    for o in outputs:
        out += _str_field(2, o)
    out += _str_field(3, name) + _str_field(4, op_type)
    for k, v in attrs.items():
        out += _len_field(5, _attr(k, v))
    return out


# ------------------------------------------------------------- op mapping

# minimum default-domain opset each emitted op type needs
_OP_MIN_OPSET = {"LayerNormalization": 17, "Gelu": 20}


def _onnx_pads(padding, what):
    """Recorded ((hb,he),(wb,we)) -> ONNX [hb, wb, he, we]
    (all-begins then all-ends order)."""
    if isinstance(padding, str):
        raise NotImplementedError(
            f"paddle_tpu_torch.onnx.export: string padding '{padding}' on "
            f"{what} is not expressible as static ONNX pads; use "
            f"explicit integer padding")
    pairs = [(int(p[0]), int(p[1])) if isinstance(p, (list, tuple))
             else (int(p), int(p)) for p in padding]
    return ([b for b, _ in pairs] + [e for _, e in pairs])


def _lower_node(node, rank_of, shape_of, idx):
    """Recorded mini-IR op -> list of ONNX node specs
    {op_type, extra_inputs?, attrs, const_inputs?}. Multi-spec entries
    chain through a fresh intermediate edge (decompositions)."""
    op = node.op_name
    a = node.attrs
    if op == "linear":
        # (x, W, b?) — Gemm is rank-2-only in ONNX; transformer-style
        # [b, s, f] inputs decompose to MatMul (+ Add)
        has_bias = sum(1 for t in node.inputs if t is not None) == 3
        if rank_of(node.inputs[0]) == 2:
            return [{"op_type": "Gemm", "attrs": {}}]
        if has_bias:
            return [{"op_type": "MatMul", "attrs": {}, "n_inputs": 2},
                    {"op_type": "Add", "attrs": {},
                     "chain_extra_input": 2}]
        return [{"op_type": "MatMul", "attrs": {}}]
    if op == "matmul":
        tx, ty = bool(a.get("transpose_x")), bool(a.get("transpose_y"))
        if not tx and not ty:
            return [{"op_type": "MatMul", "attrs": {}}]
        if (rank_of(node.inputs[0]) == 2
                and rank_of(node.inputs[1]) == 2):
            return [{"op_type": "Gemm",
                     "attrs": {"transA": int(tx), "transB": int(ty)}}]
        raise NotImplementedError(
            "paddle_tpu_torch.onnx.export: transposed matmul with rank>2 "
            "operands is not mapped; pre-transpose explicitly")
    if op == "conv2d":
        return [{"op_type": "Conv", "attrs": {
            "strides": [int(s) for s in a.get("stride", (1, 1))],
            "pads": _onnx_pads(a.get("padding", ((0, 0), (0, 0))),
                               "conv2d"),
            "dilations": [int(d) for d in a.get("dilation", (1, 1))],
            "group": int(a.get("groups", 1))}}]
    simple = {"add": "Add", "subtract": "Sub", "multiply": "Mul",
              "divide": "Div", "relu": "Relu", "sigmoid": "Sigmoid",
              "tanh": "Tanh", "exp": "Exp", "sqrt": "Sqrt", "erf": "Erf",
              "pow": "Pow", "maximum": "Max", "minimum": "Min",
              "abs": "Abs", "floor": "Floor", "ceil": "Ceil",
              "gelu": "Gelu"}
    if op in simple:
        return [{"op_type": simple[op], "attrs": {}}]
    if op == "softmax":
        return [{"op_type": "Softmax",
                 "attrs": {"axis": int(a.get("axis", -1))}}]
    if op == "reshape":
        return [{"op_type": "Reshape", "attrs": {},
                 "const_inputs": [np.asarray(a["shape"], np.int64)]}]
    if op == "transpose":
        return [{"op_type": "Transpose",
                 "attrs": {"perm": list(a["perm"])}}]
    if op == "concat_":
        return [{"op_type": "Concat",
                 "attrs": {"axis": int(a.get("axis", 0))}}]
    if op == "flatten_":
        # ONNX Flatten always yields rank 2, paddle's preserves leading
        # dims — lower to Reshape. Dynamic dims: leading ones keep their
        # index, so Reshape's 0 (copy-from-input) expresses them; at most
        # one -1 covers a dynamic collapsed group or trailing dim.
        shape = shape_of(node.inputs[0])
        nd = len(shape)
        start = int(a.get("start", 0)) % nd
        stop = int(a.get("stop", -1)) % nd

        def dyn(d):
            return d in (None, -1)

        out_shape: List[int] = [0 if dyn(d) else int(d)
                                for d in shape[:start]]
        group = shape[start:stop + 1]
        if any(dyn(d) for d in group):
            out_shape.append(-1)
            minus_used = True
        else:
            mid = 1
            for d in group:
                mid *= int(d)
            out_shape.append(mid)
            minus_used = False
        for d in shape[stop + 1:]:
            if dyn(d):
                # index shifted: 0 would copy the wrong input dim
                if minus_used:
                    raise NotImplementedError(
                        "paddle_tpu_torch.onnx.export: flatten with multiple "
                        "dynamic dims after the collapsed range is not "
                        "expressible as one ONNX Reshape")
                out_shape.append(-1)
                minus_used = True
            else:
                out_shape.append(int(d))
        return [{"op_type": "Reshape", "attrs": {},
                 "const_inputs": [np.asarray(out_shape, np.int64)]}]
    if op in ("mean", "sum_"):
        # axes travel as a const INPUT: ReduceSum-13 / ReduceMean-18
        # moved axes off the attribute form
        ax = a.get("axis")
        attrs_ = {"keepdims": int(bool(a.get("keepdim", False)))}
        spec = {"op_type": "ReduceMean" if op == "mean" else "ReduceSum",
                "attrs": attrs_}
        if ax is not None:
            axes = [int(ax)] if isinstance(
                ax, (int, np.integer)) else [int(x) for x in ax]
            spec["const_inputs"] = [np.asarray(axes, np.int64)]
            # axes-as-input exists from ReduceSum-13 / ReduceMean-18
            spec["min_opset"] = 18 if op == "mean" else 13
        return [spec]
    if op in ("max_pool_nd", "avg_pool_nd"):
        if a.get("fmt", "NCHW") != "NCHW" or len(a["ksize"]) != 2:
            raise NotImplementedError(
                "paddle_tpu_torch.onnx.export: only NCHW 2-D pooling maps to "
                "ONNX MaxPool/AveragePool")
        attrs_ = {"kernel_shape": [int(k) for k in a["ksize"]],
                  "strides": [int(s) for s in a["stride"]],
                  "pads": _onnx_pads(a.get("padding", ((0, 0), (0, 0))),
                                     op)}
        if a.get("ceil_mode"):
            attrs_["ceil_mode"] = 1
        return [{"op_type": "MaxPool" if op == "max_pool_nd"
                 else "AveragePool", "attrs": attrs_}]
    if op == "adaptive_avg_pool2d" and tuple(a.get("out_hw", ())) == (1, 1):
        return [{"op_type": "GlobalAveragePool", "attrs": {}}]
    if op == "layer_norm":
        return [{"op_type": "LayerNormalization",
                 "attrs": {"epsilon": float(a.get("eps", 1e-5))}}]
    if op == "cast":
        return [{"op_type": "Cast",
                 "attrs": {"to": _TENSORPROTO_DTYPE[str(a["dtype"])]}}]
    raise NotImplementedError(
        f"paddle_tpu_torch.onnx.export: recorded op '{op}' has no ONNX "
        f"mapping yet (attrs={a})")


# ----------------------------------------------------------------- export

def _constant(t) -> np.ndarray:
    """A captured input as the array its initializer holds: a tensor's
    payload, a Python scalar as the one-element array the reference's
    recording holds for it (float64 or int64)."""
    from ._core.tensor import Tensor
    if isinstance(t, Tensor):
        t = t._t
    if isinstance(t, torch.Tensor):
        from .jit.api import _numpy
        return _numpy(t)
    return np.asarray([t])


def export(layer, path: str, input_spec=None, opset_version: int = None,
           **configs) -> str:
    """Record `layer` with input_spec (list of paddle.static.InputSpec or
    example Tensors), map the recorded graph to ONNX, write
    `<path>.onnx`. Returns the file path (python/paddle/onnx export API).
    """
    from . import static
    from ._core import dtype as dtypes_mod
    from ._core.tensor import Tensor

    if input_spec is None:
        raise ValueError("input_spec is required (shapes define the "
                         "exported graph)")
    if not path.endswith(".onnx"):
        path = path + ".onnx"

    was_static = static.in_static_mode()
    prog = static.Program()
    feeds = []
    static.enable_static()
    try:
        with static.program_guard(prog):
            args = []
            for i, spec in enumerate(input_spec):
                if isinstance(spec, Tensor) and not isinstance(
                        spec, static.Variable):
                    shape, dtype = spec.shape, spec.dtype.name
                else:
                    shape = spec.shape
                    dtype = dtypes_mod.to_dtype(
                        getattr(spec, "dtype", "float32")).name
                name = getattr(spec, "name", None) or f"x{i}"
                v = static.data(name, shape, dtype)
                feeds.append(v)
                args.append(v)
            outs = layer(*args)
    finally:
        if not was_static:
            static.disable_static()
    outs = outs if isinstance(outs, (tuple, list)) else (outs,)

    # name every edge; collect captured parameters as initializers
    names: Dict[int, str] = {}
    initializers: List[bytes] = []
    counter = [0]

    def name_of(t) -> str:
        if isinstance(t, static.Variable):
            if id(t) not in names:
                names[id(t)] = t.name or f"t{counter[0]}"
                counter[0] += 1
            return names[id(t)]
        if isinstance(t, (Tensor, torch.Tensor)) and id(t) in names:
            return names[id(t)]
        nm = f"param_{len(initializers)}"
        if isinstance(t, (Tensor, torch.Tensor)):
            names[id(t)] = nm   # a Python scalar is a fresh constant
        initializers.append(_tensor(_constant(t), nm))
        return nm

    def rank_of(t):
        if t is None:
            return 0
        if isinstance(t, static.Variable):
            return len(t.var_shape)
        return _constant(t).ndim

    def shape_of(t):
        if isinstance(t, static.Variable):
            return list(t.var_shape)
        return list(_constant(t).shape)

    def np_dtype(v):
        return dtypes_mod.from_torch(v.var_dtype).name

    nodes: List[bytes] = []
    if opset_version is None:
        from ._core.flags import flag_value
        opset_version = flag_value("FLAGS_onnx_opset")
    needed_opset = opset_version
    for i, node in enumerate(prog.ops):
        specs = _lower_node(node, rank_of, shape_of, i)
        in_names = [name_of(t) for t in node.inputs if t is not None]
        out_names = [name_of(o) for o in node.outputs]
        prev_out = None
        for j, spec in enumerate(specs):
            op_type = spec["op_type"]
            needed_opset = max(needed_opset,
                               _OP_MIN_OPSET.get(op_type, 0),
                               spec.get("min_opset", 0))
            if j == 0:
                ins = in_names[:spec.get("n_inputs", len(in_names))]
            else:  # chained decomposition step
                ins = [prev_out]
                extra = spec.get("chain_extra_input")
                if extra is not None:
                    ins.append(in_names[extra])
            for k, const in enumerate(spec.get("const_inputs", ())):
                cname = f"const_{i}_{j}_{k}"
                initializers.append(_tensor(const, cname))
                ins.append(cname)
            if j == len(specs) - 1:
                outs_j = out_names
            else:
                prev_out = f"mid_{i}_{j}"
                outs_j = [prev_out]
            nodes.append(_node(op_type, ins, outs_j,
                               f"{node.op_name}_{i}_{j}", spec["attrs"]))

    graph = b""
    for n in nodes:
        graph += _len_field(1, n)
    graph += _str_field(2, type(layer).__name__)
    for ini in initializers:
        graph += _len_field(5, ini)
    for v in feeds:
        graph += _len_field(11, _value_info(name_of(v), v.var_shape,
                                            np_dtype(v)))
    for o in outs:
        graph += _len_field(12, _value_info(name_of(o), o.var_shape,
                                            np_dtype(o)))

    model = (_int_field(1, 8)                      # ir_version
             + _str_field(2, "paddle_tpu_torch")   # producer_name
             + _len_field(7, graph)
             + _len_field(8, _str_field(1, "")     # default domain
                          + _int_field(2, needed_opset)))
    with open(path, "wb") as f:
        f.write(model)
    return path


# ------------------------------------------------------------------ read
# Minimal wire reader for validation + tests (not a general onnx impl).

def _read_fields(buf: bytes):
    i, n = 0, len(buf)
    while i < n:
        tag = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            tag |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, v
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            yield field, buf[i:i + ln]
            i += ln
        elif wire == 5:
            yield field, struct.unpack("<f", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")


def load_model(path: str) -> Dict[str, Any]:
    """Parse an exported .onnx back into a dict for inspection."""
    with open(path, "rb") as f:
        buf = f.read()
    model = {"nodes": [], "initializers": {}, "inputs": [],
             "outputs": [], "opset": None, "producer": None}
    for field, val in _read_fields(buf):
        if field == 2:
            model["producer"] = val.decode()
        elif field == 8:
            for f2, v2 in _read_fields(val):
                if f2 == 2:
                    model["opset"] = v2
        elif field == 7:
            for f2, v2 in _read_fields(val):
                if f2 == 1:     # node
                    node = {"inputs": [], "outputs": [], "attrs": {}}
                    for f3, v3 in _read_fields(v2):
                        if f3 == 1:
                            node["inputs"].append(v3.decode())
                        elif f3 == 2:
                            node["outputs"].append(v3.decode())
                        elif f3 == 4:
                            node["op_type"] = v3.decode()
                        elif f3 == 5:
                            def s64(v):  # int64 varints are 2's-comp
                                return (v - (1 << 64)
                                        if isinstance(v, int)
                                        and v >= 1 << 63 else v)
                            aname, aval = None, None
                            ints = []
                            for f4, v4 in _read_fields(v3):
                                if f4 == 1:
                                    aname = v4.decode()
                                elif f4 == 2:
                                    aval = v4
                                elif f4 == 3:
                                    aval = s64(v4)
                                elif f4 == 8:
                                    ints.append(s64(v4))
                            node["attrs"][aname] = ints or aval
                    model["nodes"].append(node)
                elif f2 == 5:   # initializer
                    dims, dtype, raw, nm = [], None, b"", None
                    for f3, v3 in _read_fields(v2):
                        if f3 == 1:
                            dims.append(v3)
                        elif f3 == 2:
                            dtype = v3
                        elif f3 == 8:
                            nm = v3.decode()
                        elif f3 == 9:
                            raw = v3
                    np_dt = {v: k for k, v in
                             _TENSORPROTO_DTYPE.items()}[dtype]
                    if np_dt == "bfloat16":
                        import ml_dtypes
                        np_dt = ml_dtypes.bfloat16
                    model["initializers"][nm] = np.frombuffer(
                        raw, np_dt).reshape(dims)
                elif f2 == 11:
                    for f3, v3 in _read_fields(v2):
                        if f3 == 1:
                            model["inputs"].append(v3.decode())
                elif f2 == 12:
                    for f3, v3 in _read_fields(v2):
                        if f3 == 1:
                            model["outputs"].append(v3.decode())
    return model
