"""The port's ``base`` (typed framework errors and the enforce helpers)
against the JAX package's, on the CPU: the same classes with the same
bases, ``except ValueError`` catching ``InvalidArgumentError`` and the
like, the helpers' messages, and the hint and the user's frame in the
message (mirroring ``tests/test_nn_utils_errors.py``'s error tests)."""
import pytest

import paddle_tpu as ref
import paddle_tpu.base.core as ref_core
import paddle_tpu_torch as pt
from paddle_tpu_torch.base import core as bcore

ERRORS = ["EnforceNotMet", "InvalidArgumentError", "NotFoundError",
          "OutOfRangeError", "PreconditionNotMetError",
          "ResourceExhaustedError", "UnavailableError",
          "UnimplementedError"]
BUILTIN = {"InvalidArgumentError": ValueError, "NotFoundError": KeyError,
           "OutOfRangeError": IndexError,
           "ResourceExhaustedError": MemoryError,
           "UnimplementedError": NotImplementedError}


@pytest.mark.parametrize("name", ERRORS)
def test_hierarchy_matches_reference(name):
    mine, theirs = getattr(bcore, name), getattr(ref_core, name)
    names = [b.__name__ for b in mine.__bases__]
    assert names == [b.__name__ for b in theirs.__bases__]
    assert [c.__name__ for c in mine.__mro__] == \
        [c.__name__ for c in theirs.__mro__]
    assert issubclass(mine, RuntimeError)
    with pytest.raises(BUILTIN.get(name, bcore.EnforceNotMet)):
        raise mine("bad")


def test_hierarchy_and_catchability():
    with pytest.raises(ValueError):         # typed multiple-inherit
        raise bcore.InvalidArgumentError("bad arg")
    with pytest.raises(bcore.EnforceNotMet):
        raise bcore.OutOfRangeError("index 9 out of range")
    with pytest.raises(NotImplementedError):
        raise bcore.UnimplementedError("later")
    try:
        raise bcore.InvalidArgumentError("caught as ValueError")
    except ValueError as e:
        assert isinstance(e, bcore.EnforceNotMet)


HELPERS = [
    ("enforce", (False, "not fine"), {}),
    ("enforce", (0, "zero", "a hint"), {}),
    ("enforce_eq", (1, 2), {}),
    ("enforce_eq", (1, 2, "custom"), {}),
    ("enforce_gt", (1, 2), {}),
    ("enforce_shape_match", ([2, 3], [3, 2]), {}),
    ("enforce_shape_match", ((2, 3), [2]), {"context": "check x"}),
]


@pytest.mark.parametrize("name,args,kw", HELPERS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(HELPERS)])
def test_enforce_helpers_raise_as_the_reference(name, args, kw):
    got = []
    for core in (ref_core, bcore):
        with pytest.raises(core.EnforceNotMet) as info:
            getattr(core, name)(*args, **kw)
        e = info.value
        got.append((type(e).__name__, e.message, e.context))
    assert got[1] == got[0]


def test_helpers_pass_when_the_condition_holds():
    bcore.enforce(True, "fine")
    bcore.enforce_eq(3, 3)
    bcore.enforce_gt(3, 2)
    bcore.enforce_shape_match([2, 3], (2, 3))
    with pytest.raises(bcore.UnavailableError):
        bcore.enforce(False, "gone", error_cls=bcore.UnavailableError)


def test_message_carries_user_frame_and_hint():
    try:
        bcore.enforce(False, "boom", context="check your input")
    except bcore.EnforceNotMet as e:
        msg = str(e)
        assert "boom" in msg and "Hint: check your input" in msg
        assert "test_torch_base.py" in msg  # user frame, not ours
        assert "paddle_tpu_torch" not in msg.split("operator <")[1]
    try:
        raise bcore.NotFoundError("no such op")
    except KeyError as e:
        assert "test_torch_base.py" in str(e)


def test_paddle_base_namespace():
    assert pt.base.core.EnforceNotMet is bcore.EnforceNotMet
    assert pt.base.InvalidArgumentError is bcore.InvalidArgumentError
    assert sorted(pt.base.__all__) == sorted(ref.base.__all__)
