"""The port's ``inference`` predictor against the JAX package's, on the
CPU: the same layer (the reference's weights crossed with
``set_state_dict``) saved by each package with ``jit.save`` and run by
each package's ``create_predictor``. Named multi-IO from the ``.pdmeta``
and outputs equal to the reference's predictor and the eager layer (fp32
rtol 1e-5, atol 1e-5, as ``tests/test_inference_analysis.py`` holds
them); each Config knob changes what runs (``disable_gpu``: the CPU;
``switch_ir_optim(False)``: the exported graph module uncompiled;
``enable_memory_optim``: one reused device buffer per input;
``enable_profile``: a profiler range per run)."""
import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _two_in(pkg):
    nn = pkg.nn

    class TwoIn(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = nn.Linear(4, 3)
            self.b = nn.Linear(5, 3)

        def forward(self, x, y):
            return self.a(x) + self.b(y)
    return TwoIn()


def _saved(tmp_path, dynamic=False):
    ref.seed(0)
    r = _two_in(ref)
    p = _two_in(pt)
    p.set_state_dict({k: np.array(v.numpy())
                      for k, v in r.state_dict().items()})
    batch = None if dynamic else 2
    paths = [None] if dynamic else []
    for pkg, layer in ((pt, p),) if dynamic else ((ref, r), (pt, p)):
        path = str(tmp_path / pkg.__name__)
        pkg.jit.save(layer, path, input_spec=[
            pkg.jit.InputSpec([batch, 4], "float32", name="img"),
            pkg.jit.InputSpec([batch, 5], "float32", name="aux")])
        paths.append(path)
    return p, paths


def _inputs(seed, batch=2):
    r = np.random.RandomState(seed)
    return (r.randn(batch, 4).astype("float32"),
            r.randn(batch, 5).astype("float32"))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_named_multi_input_predictor(tmp_path):
    p, (rpath, ppath) = _saved(tmp_path)
    rpred = ref.inference.create_predictor(ref.inference.Config(rpath))
    pred = pt.inference.create_predictor(pt.inference.Config(ppath))
    assert pred.get_input_names() == rpred.get_input_names() == \
        ["img", "aux"]
    assert pred.get_output_names() == rpred.get_output_names() == ["out0"]
    x, y = _inputs(0)
    for pr in (pred, rpred):
        pr.get_input_handle("img").copy_from_cpu(x)
        pr.get_input_handle("aux").copy_from_cpu(y)
        pr.run()
    got = pred.get_output_handle("out0").copy_to_cpu()
    _close(got, rpred.get_output_handle("out0").copy_to_cpu())
    _close(got, p(pt.to_tensor(x), pt.to_tensor(y)).numpy())


def test_config_knobs_have_effects(tmp_path):
    p, (_, ppath) = _saved(tmp_path)
    x, y = _inputs(1)
    want = p(pt.to_tensor(x), pt.to_tensor(y)).numpy()

    cfg = pt.inference.Config(ppath)
    assert cfg.ir_optim() and not cfg.memory_optim()
    pred = pt.inference.create_predictor(cfg)
    _close(pred.run([x, y])[0], want)
    assert len(pred._compiled) == 1          # compiled once, then reused
    pred.run([x, y])
    assert len(pred._compiled) == 1 and not pred._buffers

    cfg = pt.inference.Config(ppath)
    cfg.enable_memory_optim()
    pred = pt.inference.create_predictor(cfg)
    _close(pred.run([x, y])[0], want)
    held = {n: b.data_ptr() for n, b in pred._buffers.items()}
    assert sorted(held) == ["aux", "img"]
    x2, y2 = _inputs(2)
    _close(pred.run([x2, y2])[0],
           p(pt.to_tensor(x2), pt.to_tensor(y2)).numpy())
    assert {n: b.data_ptr() for n, b in pred._buffers.items()} == held

    cfg = pt.inference.Config(ppath)
    cfg.disable_gpu()
    assert not cfg.use_gpu()
    pred = pt.inference.create_predictor(cfg)
    assert pred._device.type == "cpu"
    _close(pred.run([x, y])[0], want)

    cfg = pt.inference.Config(ppath)
    cfg.switch_ir_optim(False)
    pred = pt.inference.create_predictor(cfg)
    _close(pred.run([x, y])[0], want)
    assert pred._compiled is None            # the graph module, uncompiled

    cfg = pt.inference.Config(ppath)
    cfg.enable_profile()
    pred = pt.inference.create_predictor(cfg)
    pred.run([x, y])
    assert "inference::run" in pred._profiler_events


def test_flags_set_the_config_defaults(tmp_path):
    pt.set_flags({"FLAGS_inference_opt_level": 0,
                  "FLAGS_inference_donate_inputs": True})
    try:
        cfg = pt.inference.Config()
        assert not cfg.ir_optim() and cfg.memory_optim()
    finally:
        pt.set_flags({"FLAGS_inference_opt_level": 2,
                      "FLAGS_inference_donate_inputs": False})


def test_dynamic_batch_predictor_and_pool(tmp_path):
    """A ``None`` batch on both inputs: the port's export gives every
    input's dim 0 one symbol (the reference gives each its own, and its
    trace of ``x + y`` then refuses to broadcast them), so the predictor
    is held against the eager layer."""
    p, (_, ppath) = _saved(tmp_path, dynamic=True)
    pool = pt.inference.PredictorPool(pt.inference.Config(ppath), size=2)
    for batch in (3, 7):
        x, y = _inputs(batch, batch)
        got = pool.retrieve(1).run([x, y])[0]
        _close(got, p(pt.to_tensor(x), pt.to_tensor(y)).numpy())
    assert len(pool.retrieve(1)._compiled) == 2   # one per signature
    assert pt.inference.get_version() == pt.__version__
