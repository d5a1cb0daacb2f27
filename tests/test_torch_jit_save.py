"""The port's ``jit.save`` / ``jit.load`` and its artifact container
(``paddle_tpu_torch.jit.native_layer``) against the JAX package's, on the
CPU.

``.pdiparams`` (the reference's container: 8-byte header length, JSON
header, raw buffers) and ``.pdmeta`` must be byte-equal to the reference's
for the same weights, fp32 and bf16; each package must read the other's
``.pdiparams``; a ``None`` batch dim must give a program that runs at any
batch (outputs against the eager layer at fp32 rtol 1e-5, atol 1e-6); the
refusals of ``tests/test_jit_container.py`` hold; the reference's
``.pdmodel`` (StableHLO) is refused by name; and a GPT saved with its
flash-attention kernel keeps the op ``flash_fwd`` in the exported program.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu.jit import api as ref_api
from paddle_tpu.jit.native_layer import NativeJitLayer as RefContainer
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch.jit import api as pt_api
from paddle_tpu_torch.jit.native_layer import NativeJitLayer


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _mlp(pkg):
    nn = pkg.nn
    return nn.Sequential(nn.Linear(6, 8), nn.ReLU(), nn.Linear(8, 3))


def _saved(tmp_path, dtype="float32"):
    ref.seed(9)
    r = _mlp(ref)
    p = _mlp(pt)
    p.set_state_dict({k: np.array(v.numpy())
                      for k, v in r.state_dict().items()})
    if dtype != "float32":
        r.astype(dtype)
        p.astype(dtype)
    rpath, ppath = str(tmp_path / "ref"), str(tmp_path / "port")
    ref.jit.save(r, rpath,
                 input_spec=[ref.static.InputSpec([None, 6], dtype)])
    pt.jit.save(p, ppath,
                input_spec=[pt.static.InputSpec([None, 6], dtype)])
    return r, p, rpath, ppath


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_and_meta_byte_equal_to_the_reference(tmp_path, dtype):
    _, _, rpath, ppath = _saved(tmp_path, dtype)
    for ext in (".pdiparams", ".pdmeta"):
        with open(rpath + ext, "rb") as a, open(ppath + ext, "rb") as b:
            assert a.read() == b.read(), ext
    meta = json.load(open(ppath + ".pdmeta"))
    assert meta == {"inputs": [{"name": "x0", "shape": [-1, 6],
                                "dtype": dtype}], "outputs": ["out0"]}


def test_each_package_reads_the_others_params(tmp_path):
    r, p, rpath, ppath = _saved(tmp_path)
    want = {k: np.array(v.numpy()) for k, v in r.state_dict().items()}
    # the containers outlive their views (the reference's C++ one unmaps
    # its file when it is freed)
    port_c, ref_c = NativeJitLayer(rpath), RefContainer(ppath)
    for got in (pt_api._load_param_file(rpath + ".pdiparams"),
                port_c.state_dict(),
                ref_api._load_param_file(ppath + ".pdiparams"),
                ref_c.state_dict()):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_dynamic_batch_dim(tmp_path):
    _, p, _, ppath = _saved(tmp_path)
    loaded = pt.jit.load(ppath)
    for batch in (4, 7, 1):
        x = np.random.RandomState(batch).randn(batch, 6).astype(np.float32)
        np.testing.assert_allclose(loaded(pt.to_tensor(x)).numpy(),
                                   p(pt.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_container_views_are_zero_copy_and_read_only(tmp_path):
    r, _, _, ppath = _saved(tmp_path)
    c = NativeJitLayer(ppath)
    state = c.state_dict()
    assert c.param_names() == list(r.state_dict())
    for k, v in r.state_dict().items():
        np.testing.assert_array_equal(state[k], v.numpy())
    with pytest.raises(ValueError):
        state[c.param_names()[0]][...] = 0
    assert len(c.program_bytes()) > 0


def test_missing_artifact_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot open"):
        NativeJitLayer(str(tmp_path / "nope"))


def test_corrupt_header_rejected(tmp_path):
    (tmp_path / "bad.pdiparams").write_bytes(
        (1 << 40).to_bytes(8, "little") + b"junk")
    with pytest.raises(RuntimeError):
        NativeJitLayer(str(tmp_path / "bad"))


def test_out_of_bounds_offsets_rejected(tmp_path):
    head = json.dumps({"w": {"dtype": "float32", "shape": [4],
                             "offsets": [0, 99999]}}).encode()
    (tmp_path / "oob.pdiparams").write_bytes(
        len(head).to_bytes(8, "little") + head + b"\0" * 8)
    with pytest.raises(RuntimeError, match="out of bounds"):
        NativeJitLayer(str(tmp_path / "oob"))


def test_legacy_pickle_refused_unless_allowed(tmp_path):
    import pickle
    path = str(tmp_path / "old.pdiparams")
    with open(path, "wb") as f:
        pickle.dump({"w": np.ones(2, np.float32)}, f)
    with pytest.raises(RuntimeError, match="legacy pickle"):
        pt_api._load_param_file(path)
    pt.set_flags({"FLAGS_allow_pickle_load": True})
    try:
        np.testing.assert_array_equal(pt_api._load_param_file(path)["w"],
                                      np.ones(2, np.float32))
    finally:
        pt.set_flags({"FLAGS_allow_pickle_load": False})


def test_reference_program_refused_by_name(tmp_path):
    _, _, rpath, _ = _saved(tmp_path)
    with pytest.raises(RuntimeError, match="StableHLO"):
        pt.jit.load(rpath)


def test_gpt_keeps_the_flash_op_in_the_saved_program(tmp_path):
    from paddle_tpu_torch.models import gpt
    cfg = gpt.GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                        num_heads=4, max_position_embeddings=128,
                        dtype="float32")
    pt.seed(0)
    model = gpt.GPTForPretraining(cfg)
    model.eval()
    path = str(tmp_path / "gpt")
    pt.jit.save(model, path,
                input_spec=[pt.static.InputSpec([None, 128], "int64")])
    loaded = pt.jit.load(path)
    flash = [n for n in loaded._program.graph.nodes
             if n.target is torch.ops.paddle_tpu_torch.flash_fwd.default]
    assert len(flash) == cfg.num_layers
    for batch in (2, 3):
        x = np.random.RandomState(batch).randint(0, 128, (batch, 128))
        np.testing.assert_allclose(loaded(pt.to_tensor(x)).numpy(),
                                   model(pt.to_tensor(x)).numpy(),
                                   rtol=1e-5, atol=1e-5)
