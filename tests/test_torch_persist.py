"""The persistent compile cache (``_core/persist.py``,
``FLAGS_executable_cache_dir``) on the CPU: the counterpart of
``tests/test_persist_cache.py``, with a small ``to_static`` model (two
``Linear`` layers and a mean, ``backend="aot_eager"``) in place of the
reference's lazy segments (the port's segments compile nothing).

- A warm load skips the trace: the second ``to_static`` of the same
  function and input signature loads the stored graph (``cache.persist.
  hit``, no trace counted), and its outputs and gradients are bit-equal to
  the traced program's; inductor's caches point into the directory.
- A cold miss counts. A truncated entry, flipped payload bytes, a bad magic
  and a wrong format version (checksum made valid again) are each a
  rejected load (``cache.persist.reject``, a logged reason), a trace, the
  same outputs and a re-stored entry that the next load hits.
- The disk budget prunes the oldest entries; with no directory the module
  does nothing. A second process warm-starts from the first one's
  directory. SOT's fast path persists its segment's graph too.

Inductor's own compile of the loaded graph hitting its FX-graph cache is
measured on the card (``chip_smoke.py`` phase 21 (b)): inductor's first
CPU compile takes ~30 s.
"""
import glob
import hashlib
import json
import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import persist

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


@pytest.fixture
def cache_dir(tmp_path):
    old = pt.get_flags(["FLAGS_executable_cache_dir"])
    env = {k: os.environ.get(k) for k in persist._CACHE_ENV}
    pt.set_flags({"FLAGS_executable_cache_dir": str(tmp_path)})
    try:
        yield tmp_path
    finally:
        pt.set_flags(old)
        assert {k: os.environ.get(k) for k in persist._CACHE_ENV} == env


class Net(pt.nn.Layer):
    def __init__(self, width=8):
        super().__init__()
        self.l1 = pt.nn.Linear(width, 16)
        self.l2 = pt.nn.Linear(16, 4)

    def forward(self, x):
        return self.l2(pt.nn.functional.relu(self.l1(x))).mean()


def _run(shape=(4, 8), seed=0):
    """A fresh compiled model from a seed: its loss, gradients and the
    cache entry of its forward (traces, loads)."""
    pt.seed(seed)
    model = pt.jit.to_static(Net(shape[1]), backend="aot_eager")
    x = pt.to_tensor(np.linspace(-1, 1, int(np.prod(shape)),
                                 dtype="float32").reshape(shape))
    loss = model(x)
    loss.backward()
    entry = next(iter(model.forward._fwd_cache.values()))
    grads = [p.grad.numpy() for p in model.parameters()]
    return loss.numpy(), grads, (entry.traces, entry.loads)


def _count(stat):
    return persist.COUNTS["cache.persist." + stat]


def _entries(d):
    return sorted(glob.glob(os.path.join(str(d), "*" + persist._SUFFIX)))


def _same(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)


def test_store_then_warm_load_skips_the_trace(cache_dir):
    s0, h0 = _count("store"), _count("hit")
    cold = _run()
    assert cold[2] == (1, 0) and _count("store") == s0 + 1
    assert len(_entries(cache_dir)) == 1
    assert os.environ["TORCHINDUCTOR_CACHE_DIR"] == \
        str(cache_dir / "inductor")
    warm = _run()
    assert warm[2] == (0, 1), "the warm start traced again"
    assert _count("hit") == h0 + 1
    _same(warm, cold)


def test_cold_miss_counts(cache_dir):
    m0 = _count("miss")
    _run((2, 8))
    assert _count("miss") == m0 + 1


def _restamp(body):
    raw = body[len(persist.MAGIC) + 65:]
    payload = pickle.loads(raw)
    payload["version"] = persist.VERSION + 99
    raw = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    return persist.MAGIC + hashlib.sha256(raw).hexdigest().encode() + \
        b"\n" + raw


def _flip(body):
    mid = len(body) // 2
    return body[:mid] + bytes([body[mid] ^ 0xFF]) + body[mid + 1:]


@pytest.mark.parametrize("label,mutate", [
    ("truncated", lambda b: b[:max(8, len(b) // 3)]),
    ("checksum", _flip),
    ("magic", lambda b: b"NOTC1\n" + b[len(persist.MAGIC):]),
    ("version", _restamp)])
def test_a_corrupt_entry_recompiles_and_heals(cache_dir, label, mutate):
    cold = _run()
    for p in _entries(cache_dir):
        Path(p).write_bytes(mutate(Path(p).read_bytes()))
    r0, s0 = _count("reject"), _count("store")
    again = _run()
    assert _count("reject") == r0 + 1, f"{label}: not rejected"
    assert again[2] == (1, 0), f"{label}: the rejected entry was used"
    assert _count("store") == s0 + 1
    _same(again, cold)
    warm = _run()
    assert warm[2] == (0, 1), f"{label}: the recompile did not heal"
    _same(warm, cold)


def test_a_reject_logs_its_reason(cache_dir, caplog):
    _run()
    for p in _entries(cache_dir):
        Path(p).write_bytes(Path(p).read_bytes()[:16])
    with caplog.at_level(logging.WARNING, logger=persist.__name__):
        _run()
    assert any("recompiling" in r.getMessage() for r in caplog.records)


def test_disk_budget_prunes_oldest(cache_dir):
    """Entries of ~0.8 MB (the traced function holds a 200000-float
    constant) against a 1 MB budget: each store drops the older ones."""
    big = np.linspace(0, 1, 200_000, dtype="float32")

    def f(x):
        return (x + pt.to_tensor(big)).mean()

    old = pt.get_flags(["FLAGS_executable_cache_disk_max_mb"])
    pt.set_flags({"FLAGS_executable_cache_disk_max_mb": 1})
    try:
        newest = None
        for rows in (1, 2, 3):
            sf = pt.jit.to_static(f, backend="aot_eager")
            sf(pt.to_tensor(np.ones((rows, 200_000), "float32")))
            newest = max(_entries(cache_dir), key=os.path.getmtime)
        left = _entries(cache_dir)
        assert sum(os.path.getsize(p) for p in left) <= 1 << 20
        assert left == [newest]
    finally:
        pt.set_flags(old)


def test_inactive_without_dir(tmp_path):
    assert not persist.ACTIVE
    counts = dict(persist.COUNTS)
    _run()
    assert not _entries(tmp_path) and dict(persist.COUNTS) == counts
    assert persist.load("traced", ("anything",)) is None
    assert persist.store("traced", ("anything",), None) is False


def test_keys_of_closures_hold_what_they_close_over():
    def make(k):
        def body(x):
            return x * k
        return body
    a, b, c = make(2.0), make(2.0), make(3.0)
    assert persist.persist_key(a) == persist.persist_key(b)
    assert persist.persist_key(a) != persist.persist_key(c)
    assert persist.persist_key({"s": frozenset({"b", "a"})}) == \
        persist.persist_key({"s": frozenset({"a", "b"})})
    assert persist.persist_key(np.zeros(3)) == \
        persist.persist_key(np.zeros(3))
    assert persist.persist_key(np.zeros(3)) != \
        persist.persist_key(np.ones(3))
    assert persist.persist_key(object()) is None
    assert persist.persist_key(Net().forward) is None


def _define(src, name):
    ns = {"__name__": "user_model"}
    exec(compile(src, "<user model>", "exec"), ns)
    return ns[name]


def test_keys_see_constants_and_class_code():
    """A function differing only in a literal, and a class differing only
    in a method's body, each get another key."""
    f2 = _define("def f(x):\n    return x * 2.0\n", "f")
    f3 = _define("def f(x):\n    return x * 3.0\n", "f")
    assert persist.persist_key(f2) == persist.persist_key(
        _define("def f(x):\n    return x * 2.0\n", "f"))
    assert persist.persist_key(f2) != persist.persist_key(f3)
    c1 = _define("class C:\n    def forward(self, x):\n"
                 "        return [x + 1]\n", "C")
    c2 = _define("class C:\n    def forward(self, x):\n"
                 "        return [x + 2]\n", "C")
    assert persist.persist_key(c1) != persist.persist_key(c2)


def test_the_source_stamp_names_the_entry(monkeypatch):
    """An edit anywhere in the port's sources gives every key another
    digest: a graph traced before the edit is not loaded after it."""
    before = persist.digest("traced", ("k",))
    assert len(persist.source_stamp()) == 64
    monkeypatch.setattr(persist, "_STAMP", "0" * 64)
    assert persist.digest("traced", ("k",)) != before


def _gpt(cfg):
    from paddle_tpu_torch.models import gpt
    pt.seed(0)
    model = gpt.GPTForPretraining(cfg)
    model.eval()
    model = pt.jit.to_static(model, backend="aot_eager")
    ids = pt.to_tensor(np.arange(16).reshape(2, 8) % cfg.vocab_size)
    with pt.no_grad():
        out = model(ids)
    entry = next(iter(model.forward._fwd_cache.values()))
    return out.numpy(), (entry.traces, entry.loads)


@pytest.mark.parametrize("change", [
    {"num_heads": 8}, {"layer_norm_eps": 1e-3}])
def test_a_model_of_another_config_misses(cache_dir, change):
    """Two GPTs of the same parameter shapes whose config differs (the
    head count the forward reshapes by, an epsilon) each trace their own
    graph: the second is not served the first's."""
    import dataclasses
    from paddle_tpu_torch.models import gpt
    cfg = dataclasses.replace(gpt.GPT_CONFIGS["gpt2-medium"],
                              num_layers=1, hidden_size=64, num_heads=4,
                              intermediate_size=128, vocab_size=64,
                              max_position_embeddings=16,
                              hidden_dropout_prob=0.0,
                              attention_dropout_prob=0.0, dtype="float32")
    first, counts = _gpt(cfg)
    assert counts == (1, 0)
    m0 = _count("miss")
    other, counts = _gpt(dataclasses.replace(cfg, **change))
    assert counts == (1, 0), f"{change}: served the other model's graph"
    assert _count("miss") == m0 + 1
    assert not np.array_equal(first, other)
    again, counts = _gpt(cfg)
    assert counts == (0, 1)
    np.testing.assert_array_equal(again, first)


def test_sot_fast_path_persists_its_segment(cache_dir):
    lin = pt.nn.Linear(8, 4)
    x = pt.to_tensor(np.ones((4, 8), "float32"))

    def f(m, a):
        return (m(a) * 2.0 + 1.0).mean()

    got = []
    with pt.no_grad():
        for _ in range(2):
            sfn = pt.jit.to_static(f, full_graph=False)
            got += [float(sfn(lin, x)) for _ in range(3)]
            got.append(sfn._entries[0].segment._compiled.persisted)
    assert got[3] is False and got[7] is True
    assert len(set(got[:3] + got[4:7])) == 1


_WARM = """
import json, sys
import numpy as np
import paddle_tpu_torch as pt
from paddle_tpu_torch._core import device, persist
sys.path.insert(0, sys.argv[2])
device._current = "cpu"
pt.set_flags({"FLAGS_executable_cache_dir": sys.argv[1]})
from test_torch_persist import _run
loss, grads, counts = _run()
print(json.dumps({"loss": loss.tolist(), "grads": [g.tolist() for g in grads],
                  "counts": counts, **persist.counters()}))
"""


def test_cross_process_warm_start(tmp_path):
    cache = tmp_path / "shared"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))

    def run_once():
        out = subprocess.run(
            [sys.executable, "-c", _WARM, str(cache), str(ROOT / "tests")],
            capture_output=True, text=True, env=env, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    cold = run_once()
    assert cold["cache.persist.store"] == 1 and cold["counts"] == [1, 0]
    warm = run_once()
    assert warm["cache.persist.hit"] >= 1 and warm["counts"] == [0, 1]
    assert warm["loss"] == cold["loss"] and warm["grads"] == cold["grads"]
