"""The port's ``nn`` surface against the JAX package's, on the CPU.

- Every public callable of ``paddle_tpu.nn``, ``paddle_tpu.nn.functional``
  and ``paddle_tpu.autograd`` exists in the port's module of the same
  path, except the re-exports of ``Tensor`` and the op machinery
  (``apply``, ``def_unary``, ``register_op``) and the ``typing`` names
  the reference imports. ``models``, ``models.bert``, ``distributed``,
  ``distributed.fleet``, ``incubate``, ``incubate.nn``, ``base`` and
  ``base.core`` are compared name for name
  (submodules and tables too), except the names ``NOT_YET`` gives to a
  later roadmap item.
- The activation, loss and common layers this slice adds, ``nn.utils``
  (``weight_norm``, ``remove_weight_norm``, ``spectral_norm``, the vector
  round trip) and ``functional_call``: forward and gradients against the
  reference with its weights crossed by ``set_state_dict``, fp32, 1e-5
  relative and absolute (1e-6 for the elementwise activation layers).
"""
import __future__
import types
import typing

import numpy as np
import pytest

import paddle_tpu as ref
import paddle_tpu.autograd  # noqa: F401
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device

REEXPORTS = {"Tensor", "apply", "def_unary", "register_op"}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _public(module):
    out = set()
    for n in dir(module):
        obj = getattr(module, n)
        if n.startswith("_") or not callable(obj) or n in REEXPORTS:
            continue
        if getattr(obj, "__module__", None) == "typing":
            continue
        out.add(n)
    return out


def _names(module):
    """Every public name of a package (submodules and tables too); of a
    plain module, the names it defines (not what it imports)."""
    out = set()
    for n in dir(module):
        obj = getattr(module, n)
        if n.startswith("_") or isinstance(obj, __future__._Feature):
            continue
        if not hasattr(module, "__path__"):
            if isinstance(obj, types.ModuleType) or (
                    callable(obj) and getattr(obj, "__module__", None)
                    != module.__name__):
                continue
        out.add(n)
    return out


_ITEM10 = "ROADMAP §1 item 10: the long tail"
_ITEM11 = ("ROADMAP §1 item 11: the compiled 1F1B, VPP and ZeroBubble "
           "schedules")
_ITEM91 = "ROADMAP §1 item 9.1: spmd.py and _constraint.py"
_DIST_LATER = ("ps", "rpc")
# fleet's parameter-server functions
_FLEET_PS = "init_server init_worker ps_client run_server stop_worker".split()
# the namespaces compared name for name, with the names each still lacks
# (a list that may only shrink; a package's submodules are among its names
# once any test has imported them, so each one not ported is listed)
NOT_YET = {
    "models": {},
    "models.bert": {},
    "distributed": {**dict.fromkeys(_DIST_LATER, _ITEM10),
                    **dict.fromkeys(("spmd", "shard_batch",
                                     "suggest_mesh_degree"), _ITEM91),
                    **dict.fromkeys(("OneFOneB", "VPP", "ZeroBubble"),
                                    _ITEM11)},
    "distributed.fleet": dict.fromkeys(_FLEET_PS, _ITEM10),
    "incubate": {"asp": _ITEM10, "distributed": _ITEM10},
    "incubate.nn": {},
    "base": {},
    "base.core": {},
    "jit": {},
    "static": {},
    "inference": {},
    "framework": {},
    "ir": {},
    "onnx": {},
    "observability": {},
    "observability.budget": dict.fromkeys(
        ("static_diff", "render_static_diff"),
        "ROADMAP §1 item 9: the analysis plane's perf checker"),
    "profiler": {},
}
# names a reference package binds to the JAX modules it imports: never
# ported (the port imports no JAX)
JAX_MODULES = {"static": ("jax", "jnp")}


@pytest.mark.parametrize("path", ["nn", "nn.functional", "autograd"]
                         + sorted(NOT_YET))
def test_every_public_callable_exists_in_the_port(path):
    import importlib
    theirs = importlib.import_module(f"paddle_tpu.{path}")
    mine = importlib.import_module(f"paddle_tpu_torch.{path}")
    # a package lists the submodules some test has imported: import the
    # port's of the same names, so the comparison does not depend on order
    for n, obj in vars(theirs).items():
        if isinstance(obj, types.ModuleType) and not n.startswith("_") \
                and obj.__name__ == f"{theirs.__name__}.{n}":
            try:
                importlib.import_module(f"paddle_tpu_torch.{path}.{n}")
            except ImportError:
                pass
    missing = sorted(_public(theirs) - _public(mine))
    if path in NOT_YET:
        missing = sorted(_names(theirs) - _names(mine) - set(NOT_YET[path])
                         - set(JAX_MODULES.get(path, ())))
        stale = sorted(n for n in NOT_YET[path] if hasattr(mine, n))
        assert not stale, stale
    assert not missing, missing


def test_eager_fusion_default_is_off_in_the_port_only():
    """The one flag whose default the port changes on purpose (ROADMAP §3):
    the reference records plain eager code into its ambient window by
    default, the port runs it op by op unless asked (lazy_guard,
    enable_eager_fusion(True), to_static(full_graph=False))."""
    from paddle_tpu._core import flags as ref_flags
    from paddle_tpu_torch._core import flags as pt_flags
    assert ref_flags._REGISTRY["FLAGS_eager_fusion"].default is True
    assert pt_flags._REGISTRY["FLAGS_eager_fusion"].default is False
    assert pt.framework.eager_fusion_enabled() is False
    for name in ("FLAGS_lazy_max_segment_ops", "FLAGS_lazy_enable",
                 "FLAGS_executable_cache_capacity", "FLAGS_record_fast_path",
                 "FLAGS_step_replay_after", "FLAGS_async_flush",
                 "FLAGS_sot_cache_entries", "FLAGS_sot_inline_depth",
                 "FLAGS_sot_step_budget", "FLAGS_sot_guard_size_cap"):
        assert pt_flags._REGISTRY[name].default \
            == ref_flags._REGISTRY[name].default, name


def test_the_port_imports_as_paddle_autograd():
    assert pt.autograd.PyLayer is __import__(
        "paddle_tpu_torch.autograd", fromlist=["PyLayer"]).PyLayer


def _pair(build):
    rm, tm = build(ref), build(pt)
    state = {k: np.array(v.numpy()) for k, v in rm.state_dict().items()}
    assert list(state) == list(tm.state_dict())
    tm.set_state_dict(state)
    return rm, tm


def _x(*shape, seed=0, lo=None):
    r = np.random.RandomState(seed)
    if lo is not None:
        return r.uniform(lo, 1 - lo, shape).astype(np.float32)
    return r.randn(*shape).astype(np.float32)


def _hold(build, inputs, tol=1e-5, grad=(0,)):
    rm, tm = _pair(build)
    got = []
    for P, m in ((ref, rm), (pt, tm)):
        ts = [P.to_tensor(a, stop_gradient=i not in grad)
              for i, a in enumerate(inputs)]
        out = m(*ts)
        r = _x(*out.shape, seed=9) if out.shape else np.float32(1.5)
        (out * P.to_tensor(r)).sum().backward()
        got.append([out.numpy()] + [ts[i].grad.numpy() for i in grad]
                   + [p.grad.numpy() for p in m.parameters()])
    assert len(got[0]) == len(got[1])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol)


ACT_LAYERS = {
    "GLU": lambda P: P.nn.GLU(),
    "SELU": lambda P: P.nn.SELU(),
    "CELU": lambda P: P.nn.CELU(0.8),
    "Hardshrink": lambda P: P.nn.Hardshrink(0.4),
    "Hardtanh": lambda P: P.nn.Hardtanh(-0.3, 0.6),
    "Softshrink": lambda P: P.nn.Softshrink(0.2),
    "Softsign": lambda P: P.nn.Softsign(),
    "Tanhshrink": lambda P: P.nn.Tanhshrink(),
    "ThresholdedReLU": lambda P: P.nn.ThresholdedReLU(0.5),
    "PReLU": lambda P: P.nn.PReLU(4, 0.1),
}


@pytest.mark.parametrize("name", sorted(ACT_LAYERS))
def test_activation_layers_match_reference(name):
    _hold(ACT_LAYERS[name], [_x(3, 4, 6) * 2], tol=1e-6)


LOSS_LAYERS = {
    "BCELoss": (lambda P: P.nn.BCELoss(), lambda: [
        _x(4, 5, lo=0.05), _x(4, 5, seed=1, lo=0.1)]),
    "KLDivLoss": (lambda P: P.nn.KLDivLoss("batchmean"), lambda: [
        _x(4, 5), _x(4, 5, seed=1, lo=0.1)]),
    "SmoothL1Loss": (lambda P: P.nn.SmoothL1Loss(delta=0.5), lambda: [
        _x(4, 5), _x(4, 5, seed=1)]),
    "MarginRankingLoss": (lambda P: P.nn.MarginRankingLoss(0.2), lambda: [
        _x(6), _x(6, seed=1), np.sign(_x(6, seed=2))]),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layers_match_reference(name):
    build, inputs = LOSS_LAYERS[name]
    _hold(build, inputs(), grad=(0, 1))


COMMON_LAYERS = {
    "Bilinear": (lambda P: P.nn.Bilinear(4, 3, 5), lambda: [
        _x(6, 4), _x(6, 3, seed=1)], (0, 1)),
    "CosineSimilarity": (lambda P: P.nn.CosineSimilarity(1), lambda: [
        _x(4, 6), _x(4, 6, seed=1)], (0, 1)),
    "RMSNorm": (lambda P: P.nn.RMSNorm(6, bias_attr=None), lambda: [
        _x(3, 4, 6)], (0,)),
    "Unfold": (lambda P: P.nn.Unfold(3, 1, 1), lambda: [
        _x(2, 3, 5, 6)], (0,)),
    "Upsample": (lambda P: P.nn.Upsample(scale_factor=2, mode="bicubic"),
                 lambda: [_x(2, 3, 4, 5)], (0,)),
    "UpsamplingBilinear2D": (lambda P: P.nn.UpsamplingBilinear2D(
        size=[7, 9]), lambda: [_x(2, 3, 4, 5)], (0,)),
    "Pad2D": (lambda P: P.nn.Pad2D([1, 2, 0, 1], mode="constant",
                                   value=0.5), lambda: [_x(2, 3, 4, 5)],
              (0,)),
    "Dropout2D_eval": (lambda P: P.nn.Dropout2D(0.5).eval(), lambda: [
        _x(2, 3, 4, 5)], (0,)),
}


@pytest.mark.parametrize("name", sorted(COMMON_LAYERS))
def test_common_layers_match_reference(name):
    build, inputs, grad = COMMON_LAYERS[name]
    _hold(build, inputs(), grad=grad)


def test_containers():
    d = pt.nn.LayerDict({"a": pt.nn.Linear(2, 3), "b": pt.nn.ReLU()})
    d["c"] = pt.nn.Linear(3, 1)
    assert list(d.keys()) == ["a", "b", "c"] and len(d) == 3
    assert list(d.state_dict()) == list(ref.nn.LayerDict(
        {"a": ref.nn.Linear(2, 3), "b": ref.nn.ReLU(),
         "c": ref.nn.Linear(3, 1)}).state_dict())
    ps = pt.nn.ParameterList([pt.create_parameter([2], "float32")])
    ps.append(pt.create_parameter([3], "float32"))
    assert len(ps) == 2 and ps[1].shape == [3]
    assert [n for n, _ in ps.named_parameters()] == ["0", "1"]


def test_weight_norm_matches_reference():
    def build(P):
        return P.nn.utils.weight_norm(P.nn.Linear(4, 3), dim=1)
    _hold(build, [_x(5, 4)])
    layer = build(pt)
    assert list(layer.state_dict()) == ["bias", "weight_v", "weight_g"]
    before = layer(pt.to_tensor(_x(5, 4))).numpy()
    pt.nn.utils.remove_weight_norm(layer)
    assert list(layer.state_dict()) == ["bias", "weight"]
    np.testing.assert_allclose(layer(pt.to_tensor(_x(5, 4))).numpy(),
                               before, rtol=1e-6, atol=1e-6)


def test_spectral_norm_matches_reference():
    """The power iteration starts from the reference's vector
    (``RandomState(0)``) and the reparameterisation runs its first
    iteration when applied, so the weights cross before it is applied;
    each call iterates again."""
    rm, tm = _pair(lambda P: P.nn.Linear(6, 4))
    ref.nn.utils.spectral_norm(rm, n_power_iterations=2)
    pt.nn.utils.spectral_norm(tm, n_power_iterations=2)
    assert list(tm.state_dict()) == list(rm.state_dict()) == \
        ["bias", "weight_orig"]
    x = _x(3, 6)
    for _ in range(2):
        got = [m(P.to_tensor(x)) for P, m in ((ref, rm), (pt, tm))]
    np.testing.assert_allclose(got[1].numpy(), got[0].numpy(), rtol=1e-5,
                               atol=1e-5)
    for out in got:
        out.sum().backward()
    for (name, rp), tp in zip(rm.named_parameters(), tm.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), rp.grad.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_parameters_to_vector_round_trip():
    layer = pt.nn.Linear(3, 2)
    vec = pt.nn.utils.parameters_to_vector(layer.parameters())
    assert vec.shape == [8]
    pt.nn.utils.vector_to_parameters(vec * 2.0, layer.parameters())
    np.testing.assert_allclose(
        pt.nn.utils.parameters_to_vector(layer.parameters()).numpy(),
        vec.numpy() * 2.0)


def test_functional_call_matches_reference():
    """The layer runs on the substituted weights and keeps its own; with
    ``return_buffers`` the batch norm's updated statistics come back."""
    x = _x(4, 3, 2, 2)
    got = []
    for P in (ref, pt):
        P.seed(0)
        bn = P.nn.BatchNorm2D(3)
        own = bn.weight.numpy().copy()
        state = {"weight": P.to_tensor(np.full(3, 2.0, np.float32)),
                 "bias": P.to_tensor(np.full(3, 0.5, np.float32))}
        out, bufs = P.nn.functional_call(bn, state, P.to_tensor(x),
                                         return_buffers=True)
        np.testing.assert_array_equal(bn.weight.numpy(), own)
        got.append([out.numpy(), np.asarray(bufs["_mean"]),
                    np.asarray(bufs["_variance"])])
    for g, w in zip(got[1], got[0]):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def test_pad2d_refuses_nhwc():
    with pytest.raises(NotImplementedError):
        pt.nn.Pad2D([1, 1, 1, 1], data_format="NHWC")


def test_typing_names_are_the_only_autograd_exceptions():
    skipped = {n for n in dir(ref.autograd) if not n.startswith("_")
               and callable(getattr(ref.autograd, n))} - _public(
                   ref.autograd)
    assert skipped <= REEXPORTS | {n for n in dir(typing)}, skipped
