"""The port's distributed checkpoint, fault injection and retry policies
(``paddle_tpu_torch/distributed/checkpoint.py``, ``resilience/faults.py``,
``resilience/retry.py``) against the reference's: the counterpart of the
checkpoint tests of ``tests/test_resilience.py`` (406-447, 846-903),
``tests/test_text_checkpoint.py:36`` and ``tests/test_distributed.py``'s
roundtrip.

- An atomic save leaves no temp file and round-trips; a flipped byte in
  ``data_rank0.pkl`` and a torn save (new data, old metadata) are refused
  with ``EnforceNotMet``; the pre-checksum format loads unverified;
  ``CheckpointManager`` keeps ``keep`` generations and falls back past a
  corrupted one, raising only when every generation is bad.
- On four gloo ranks: a state saved sharded on a ``[4]`` mesh loads into a
  ``[2, 2]`` mesh with other placements (reshard on load), each rank's
  piece the reference's shard on the device of the same number.
- Between the packages: a checkpoint the port's ranks save loads in the
  reference, and one the reference saves loads in the port's ranks (fp32).
  bf16: the port writes it as float32 with ``bfloat16`` recorded, which
  either package loads without ``ml_dtypes``; the reference's bf16 (an
  ``ml_dtypes`` array) loads in the port where ``ml_dtypes`` imports and
  is refused where it does not.
- ``FaultPlan`` fires the reference's schedule for the same seed and calls;
  ``RetryPolicy`` sleeps the reference's backoff and retries the same
  classes; the ``ckpt::save`` / ``ckpt::load`` sites fire under
  ``FLAGS_fault_inject``.
"""
import json
import logging
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.distributed as rdist
import paddle_tpu_torch as pt
import torch_dist_ranks as W
from paddle_tpu.distributed.resilience import faults as rfaults
from paddle_tpu.distributed.resilience import retry as rretry
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch.base.core import EnforceNotMet
from paddle_tpu_torch.distributed import checkpoint as ckpt
from paddle_tpu_torch.distributed.resilience import faults, retry
from paddle_tpu_torch.testing.dist import World


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture(scope="module")
def world():
    with World(4, timeout=60) as w:
        yield w


def _roundtrip_state():
    return {"w": pt.to_tensor(np.arange(12, dtype=np.float32).reshape(3, 4)),
            "step": 7}


def _flip(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0xFF     # one flipped byte mid-pickle
    open(path, "wb").write(bytes(blob))


# ------------------------------------------------ one process, one file

def test_checkpoint_atomic_save_and_checksum_roundtrip(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_state_dict(_roundtrip_state(), path)
    assert not [f for f in os.listdir(path) if f.startswith(".tmp_")]
    target = {"w": pt.to_tensor(np.zeros((3, 4), np.float32)), "step": 0}
    ckpt.load_state_dict(target, path)
    np.testing.assert_array_equal(target["w"].numpy(),
                                  np.arange(12).reshape(3, 4))
    assert target["step"] == 7


def test_checkpoint_corruption_detected(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_state_dict(_roundtrip_state(), path)
    _flip(os.path.join(path, "data_rank0.pkl"))
    with pytest.raises(EnforceNotMet, match="corrupted"):
        ckpt.load_state_dict(_roundtrip_state(), path)


def test_checkpoint_torn_save_detected(tmp_path):
    """New data under the old metadata: its checksum refuses the data."""
    path = str(tmp_path / "ckpt")
    ckpt.save_state_dict(_roundtrip_state(), path)
    data = {"w": np.ones((3, 4), np.float32), "step": 8}
    open(os.path.join(path, "data_rank0.pkl"), "wb").write(
        pickle.dumps(data))
    with pytest.raises(EnforceNotMet, match="corrupted"):
        ckpt.load_state_dict(_roundtrip_state(), path)


def test_checkpoint_pre_checksum_format_still_loads(tmp_path):
    path = tmp_path / "ckpt"
    path.mkdir()
    data = {"w": np.full((3, 4), 2.0, np.float32), "step": 3}
    (path / "data_rank0.pkl").write_bytes(pickle.dumps(data))
    (path / "metadata.pkl").write_bytes(pickle.dumps({"w": {}, "step": {}}))
    target = _roundtrip_state()
    ckpt.load_state_dict(target, str(path))
    np.testing.assert_array_equal(target["w"].numpy(), data["w"])
    assert target["step"] == 3


def test_strict_load_refuses_a_key_mismatch(tmp_path):
    path = str(tmp_path / "ckpt")
    ckpt.save_state_dict(_roundtrip_state(), path)
    with pytest.raises(KeyError, match="mismatch"):
        ckpt.load_state_dict({"w": _roundtrip_state()["w"]}, path)
    pt_flags.set_flags({"FLAGS_ckpt_strict_load": False})
    try:
        target = {"w": pt.to_tensor(np.zeros((3, 4), np.float32))}
        ckpt.load_state_dict(target, path)
        assert target["w"].numpy()[2, 3] == 11
    finally:
        pt_flags.set_flags({"FLAGS_ckpt_strict_load": True})


def test_checkpoint_manager_retention_and_manifest(tmp_path):
    root = str(tmp_path / "gens")
    mgr = ckpt.CheckpointManager(root, keep=3)
    for i in range(5):
        state = {"w": pt.to_tensor(np.full((2, 2), float(i), np.float32)),
                 "step": i}
        assert mgr.save(state, step=i) == i + 1
    assert mgr.generations() == [3, 4, 5]
    assert sorted(d for d in os.listdir(root) if d.startswith("gen_")) == \
        ["gen_00000003", "gen_00000004", "gen_00000005"]
    manifest = json.load(open(os.path.join(root, "MANIFEST.json")))
    assert [e["gen"] for e in manifest["generations"]] == [3, 4, 5]
    target = {"w": pt.to_tensor(np.zeros((2, 2), np.float32)), "step": -1}
    assert mgr.load(target) == 5 and target["step"] == 4
    assert mgr.load(target, generation=3) == 3 and target["step"] == 2


def test_checkpoint_manager_fallback_on_corruption(tmp_path, caplog):
    """A corrupted latest generation falls back to the newest verified
    older one with a logged reason, and raises only when every
    generation is bad."""
    root = str(tmp_path / "gens")
    mgr = ckpt.CheckpointManager(root, keep=3)
    for i in range(3):
        mgr.save({"w": pt.to_tensor(np.full((2, 2), float(i), np.float32))},
                 step=i)

    def corrupt(gen):
        _flip(os.path.join(root, f"gen_{gen:08d}", "data_rank0.pkl"))

    corrupt(3)
    target = {"w": pt.to_tensor(np.zeros((2, 2), np.float32))}
    with caplog.at_level(logging.WARNING, logger=ckpt.__name__):
        assert mgr.load(target) == 2
    np.testing.assert_array_equal(target["w"].numpy(), np.full((2, 2), 1.0))
    assert any("fallback: loaded gen 2" in r.getMessage()
               for r in caplog.records)
    corrupt(2)
    corrupt(1)
    with pytest.raises(EnforceNotMet, match="failed verification"):
        mgr.load(target)


def test_checkpoint_manager_keep_follows_the_flag(tmp_path):
    mgr = ckpt.CheckpointManager(str(tmp_path / "gens"))
    assert mgr.keep == 3
    pt_flags.set_flags({"FLAGS_checkpoint_keep": 1})
    try:
        for i in range(2):
            mgr.save({"w": pt.to_tensor(np.zeros(2, np.float32))}, step=i)
        assert mgr.generations() == [2]
    finally:
        pt_flags.set_flags({"FLAGS_checkpoint_keep": 3})


# ------------------------------------------------ between the packages

def test_a_port_checkpoint_loads_in_the_reference_and_back(tmp_path):
    """fp32 both ways, plain tensors and a non-tensor entry."""
    r = np.random.RandomState(0)
    arrs = {"a": r.randn(4, 6).astype("float32"),
            "b": r.randint(0, 9, (5,)).astype("int64")}
    port_path, ref_path = str(tmp_path / "port"), str(tmp_path / "ref")
    ckpt.save_state_dict({**{k: pt.to_tensor(v) for k, v in arrs.items()},
                          "step": 3}, port_path)
    target = {k: ref.to_tensor(np.zeros_like(v)) for k, v in arrs.items()}
    target["step"] = 0
    rdist.load_state_dict(target, port_path)
    for k, v in arrs.items():
        np.testing.assert_array_equal(target[k].numpy(), v)
    assert target["step"] == 3
    rdist.save_state_dict({**{k: ref.to_tensor(v) for k, v in arrs.items()},
                           "step": 4}, ref_path)
    mine = {k: pt.to_tensor(np.zeros_like(v)) for k, v in arrs.items()}
    mine["step"] = 0
    ckpt.load_state_dict(mine, ref_path)
    for k, v in arrs.items():
        np.testing.assert_array_equal(mine[k].numpy(), v)
    assert mine["step"] == 4


def _bf16_values():
    """Values that bf16 holds exactly."""
    r = np.random.RandomState(1)
    return torch.from_numpy(r.randn(3, 5).astype("float32")).bfloat16() \
        .float().numpy()


def test_a_port_bf16_checkpoint_needs_no_ml_dtypes(tmp_path, monkeypatch):
    x = _bf16_values()
    path = str(tmp_path / "ckpt")
    ckpt.save_state_dict({"w": pt.to_tensor(x, dtype="bfloat16")}, path)
    blob = open(os.path.join(path, "data_rank0.pkl"), "rb").read()
    assert b"ml_dtypes" not in blob
    meta = pickle.load(open(os.path.join(path, "metadata.pkl"), "rb"))
    assert meta["w"]["dtype"] == "bfloat16"
    # the reference loads it into its bf16 target
    rt = {"w": ref.to_tensor(np.zeros_like(x)).astype("bfloat16")}
    rdist.load_state_dict(rt, path)
    np.testing.assert_array_equal(np.asarray(rt["w"].numpy(), np.float32), x)
    # and the port does with ml_dtypes unimportable
    for name in [m for m in sys.modules if m.split(".")[0] == "ml_dtypes"]:
        monkeypatch.setitem(sys.modules, name, None)
    mine = {"w": pt.to_tensor(np.zeros_like(x), dtype="bfloat16")}
    ckpt.load_state_dict(mine, path)
    assert mine["w"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(mine["w"].numpy(), x)


def test_a_reference_bf16_checkpoint_loads_only_with_ml_dtypes(
        tmp_path, monkeypatch):
    x = _bf16_values()
    path = str(tmp_path / "ckpt")
    rdist.save_state_dict({"w": ref.to_tensor(x).astype("bfloat16")}, path)
    mine = {"w": pt.to_tensor(np.zeros_like(x), dtype="bfloat16")}
    ckpt.load_state_dict(mine, path)
    np.testing.assert_array_equal(mine["w"].numpy(), x)
    for name in [m for m in sys.modules if m.split(".")[0] == "ml_dtypes"]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ModuleNotFoundError):
        ckpt.load_state_dict(mine, path)


# ------------------------------------------------------ on four ranks

def _ref_mesh(shape, names):
    return rdist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                             dim_names=list(names))


def _ref_pieces(t):
    return {sh.device.id: np.asarray(sh.data)
            for sh in t._value.addressable_shards}


def test_reshard_on_load_across_meshes_and_packages(world, tmp_path):
    """test_text_checkpoint.py:36 and test_distributed.py's roundtrip:
    saved Shard(0) on a [4] mesh by the port's ranks, loaded into a
    [2, 2] mesh as [Replicate, Shard(1)] (and [Shard(0), Replicate]) by
    the ranks and by the reference, each rank's piece the reference's
    shard; then the reference's save of the same loads in the ranks."""
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    v = np.arange(16, dtype=np.float32).reshape(4, 4) / 7
    arrays = {"w": w, "v": v}
    path = str(tmp_path / "port")
    files = world.run(W.checkpoint_save, path, (4,), ["x"], arrays,
                      {"w": "S0", "v": "R"}, {"step": 5})
    assert files[0] == ["data_rank0.pkl", "metadata.pkl"]
    mesh_b = _ref_mesh((2, 2), ["dp", "mp"])
    for spec in ("R S1", "S0 R"):
        pl = [rdist.Replicate() if s == "R" else rdist.Shard(int(s[1]))
              for s in spec.split()]
        target = {"w": rdist.shard_tensor(ref.zeros([8, 8]), mesh_b, pl),
                  "v": ref.zeros([4, 4]), "step": 0}
        out = rdist.load_state_dict(target, path)
        want = _ref_pieces(out["w"])
        got = world.run(W.checkpoint_load, path, (2, 2), ["dp", "mp"],
                        arrays, {"w": spec, "v": "R R"}, ["step"])
        for r, (pieces, extra) in enumerate(got):
            np.testing.assert_array_equal(pieces["w"], want[r])
            np.testing.assert_array_equal(pieces["v"], v)
            assert extra == {"step": 5}
        np.testing.assert_array_equal(out["v"].numpy(), v)
    # the reference's checkpoint, sharded on its [4] mesh, into the ranks
    ref_path = str(tmp_path / "ref")
    mesh_a = _ref_mesh((4,), ["x"])
    rdist.save_state_dict(
        {"w": rdist.shard_tensor(ref.to_tensor(w), mesh_a,
                                 [rdist.Shard(0)]),
         "v": ref.to_tensor(v), "step": 6}, ref_path)
    got = world.run(W.checkpoint_load, ref_path, (2, 2), ["dp", "mp"],
                    arrays, {"w": "R S1", "v": "S1 R"}, ["step"])
    for r, (pieces, extra) in enumerate(got):
        np.testing.assert_array_equal(pieces["w"],
                                      w[:, 4 * (r % 2):][:, :4])
        np.testing.assert_array_equal(pieces["v"],
                                      v[:, 2 * (r // 2):][:, :2])
        assert extra == {"step": 6}


def test_a_partial_tensor_saves_its_sum_and_bf16_shards_load(world,
                                                             tmp_path):
    """A Partial DistTensor is saved as its global value (the sum of the
    contributions); a bf16 one sharded on the ranks round-trips
    exactly."""
    x = _bf16_values()[:, :4]
    h = np.concatenate([x, -x[:1]])   # 4 x 4, bf16 values
    path = str(tmp_path / "ckpt")
    world.run(W.checkpoint_save, path, (2, 2), ["x", "y"],
              {"p": x, "h_bf16": h}, {"p": "P S1", "h_bf16": "S1 R"}, {})
    data = pickle.load(open(os.path.join(path, "data_rank0.pkl"), "rb"))
    np.testing.assert_array_equal(data["p"], x)
    assert data["h_bf16"].dtype == np.float32
    np.testing.assert_array_equal(data["h_bf16"], h)
    got = world.run(W.checkpoint_load, path, (2, 2), ["x", "y"],
                    {"p": x, "h_bf16": h}, {"p": "R R", "h_bf16": "R S0"},
                    [])
    for r, (pieces, _) in enumerate(got):
        np.testing.assert_array_equal(pieces["p"], x)
        np.testing.assert_array_equal(pieces["h_bf16"],
                                      h[2 * (r % 2):][:2])


# ------------------------------------------------ faults and retries

def _drive(plan):
    for _ in range(40):
        for site in ("comm::all_reduce", "store::get", "ckpt::save"):
            try:
                plan.fire(site)
            except Exception as e:  # the kinds are held below
                plan.fired.append(("raised", type(e).__name__))
    return list(plan.fired)


@pytest.mark.parametrize("spec", [
    "seed=7;comm::all_reduce@*=fail:0.5;store::get@*=delay:0.5",
    "seed=8;comm::all_reduce@*=fail:0.5;store::get@*=delay:0.5",
    "seed=1;step::3=die;comm::*@2=stuck(0.0);x::y=fail;ckpt::*@*=oom:0.3",
])
def test_fault_plan_fires_the_reference_s_schedule(spec):
    mine = _drive(faults.FaultPlan(spec, sleep=lambda s: None))
    theirs = _drive(rfaults.FaultPlan(spec, sleep=lambda s: None))
    assert mine == theirs and mine


def test_fault_plan_sites_occurrences_and_kinds():
    p = faults.FaultPlan("seed=1;step::3=die;comm::*@2=stuck(0.0);x::y=fail")
    p.fire("step::1")
    with pytest.raises(faults.RankDeath):
        p.fire("step::3")
    p.fire("comm::send")
    with pytest.raises(faults.CollectiveTimeout):
        p.fire("comm::recv")
    with pytest.raises(faults.TransientFault):
        p.fire("x::y")
    assert [f[2] for f in p.fired] == ["die", "stuck", "fail"]
    for bad in ("step::1=explode", "not an entry"):
        with pytest.raises(ValueError):
            faults.FaultPlan(bad)


def test_fault_sites_of_the_checkpoint_follow_the_flag(tmp_path):
    path = str(tmp_path / "ckpt")
    assert not faults.ACTIVE and faults.plan() is None
    pt_flags.set_flags({"FLAGS_fault_inject": "ckpt::save=fail;"
                                              "ckpt::load@2=die"})
    try:
        assert faults.ACTIVE and faults.plan().rules[0].site == "ckpt::save"
        with pytest.raises(faults.TransientFault):
            ckpt.save_state_dict(_roundtrip_state(), path)
        ckpt.save_state_dict(_roundtrip_state(), path)  # first only
        ckpt.load_state_dict(_roundtrip_state(), path)
        with pytest.raises(faults.RankDeath):
            ckpt.load_state_dict(_roundtrip_state(), path)
    finally:
        pt_flags.set_flags({"FLAGS_fault_inject": ""})
    assert not faults.ACTIVE and faults.plan() is None


def test_retry_policy_backoff_is_the_reference_s():
    for kw in ({}, {"base_delay": 0.2, "multiplier": 3.0, "max_delay": 1.0,
                    "jitter": 0.5}):
        mine, theirs = retry.RetryPolicy("ckpt", **kw), \
            rretry.RetryPolicy("ckpt", **kw)
        assert [mine.delay(a) for a in range(1, 7)] == \
            [theirs.delay(a) for a in range(1, 7)]
    for name in ("store_policy", "bringup_policy", "comm_policy",
                 "ckpt_policy", "grow_policy"):
        a, b = getattr(retry, name)(), getattr(rretry, name)()
        assert a.name == b.name and a.max_delay == b.max_delay
        assert [c.__name__ for c in a.retryable] == \
            [c.__name__ for c in b.retryable]


def test_retry_policy_retries_gives_up_and_spares_rank_death():
    calls, slept = [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise faults.TransientFault("t", "fail", len(calls))
        return "ok"

    pol = retry.RetryPolicy("t", max_attempts=5, base_delay=0.01,
                            sleep=slept.append)
    assert pol.run(flaky) == "ok" and len(calls) == 3
    assert slept == [pol.delay(1), pol.delay(2)]

    def always():
        calls.append(1)
        raise faults.TransientFault("t", "fail", 1)

    calls.clear()
    with pytest.raises(faults.TransientFault):
        retry.RetryPolicy("t", max_attempts=3, base_delay=0.0).run(always)
    assert len(calls) == 3

    def dead():
        calls.append(1)
        raise faults.RankDeath("t", "die", 1)

    calls.clear()
    with pytest.raises(faults.RankDeath):
        retry.RetryPolicy("t", max_attempts=5, base_delay=0.0).run(dead)
    assert len(calls) == 1


def test_checkpoint_io_retries_a_transient_os_error(tmp_path, monkeypatch):
    failures = []
    write = ckpt._atomic_write

    def flaky_write(path, blob):
        if not failures:
            failures.append(path)
            raise OSError("disk hiccup")
        write(path, blob)

    monkeypatch.setattr(ckpt, "_atomic_write", flaky_write)
    pt_flags.set_flags({"FLAGS_retry_backoff_s": 0.0})
    try:
        ckpt.save_state_dict(_roundtrip_state(), str(tmp_path / "c"))
    finally:
        pt_flags.set_flags({"FLAGS_retry_backoff_s": 0.05})
    assert len(failures) == 1
    target = {"w": pt.to_tensor(np.zeros((3, 4), np.float32)), "step": 0}
    ckpt.load_state_dict(target, str(tmp_path / "c"))
    assert target["step"] == 7


def test_the_flags_have_the_reference_s_defaults():
    from paddle_tpu._core import flags as ref_flags
    for name in ("FLAGS_pipeline_max_inflight", "FLAGS_pipeline_stash_warn_mb",
                 "FLAGS_zb_w_extra_delay", "FLAGS_fault_inject",
                 "FLAGS_retry_max_attempts", "FLAGS_retry_backoff_s",
                 "FLAGS_checkpoint_keep", "FLAGS_ckpt_strict_load"):
        assert pt_flags._REGISTRY[name].default == \
            ref_flags._REGISTRY[name].default, name
