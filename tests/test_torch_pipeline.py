"""The port's eager pipeline in one process (``paddle_tpu_torch/distributed/
pipeline.py``, ``fleet/recompute.py``) against the reference's
(``paddle_tpu.distributed.pipeline``).

- The three schedule functions give the reference's action lists:
  ``_fb_schedule`` for P 1-4, m 1-8, every rank, both schedules;
  ``_interleave_schedule`` for C 2-3, P 1-4, m 1-12, with its contract's
  ``ValueError`` wherever the reference raises; ``_zero_bubble_schedule``
  for P 1-4, m 1-8 under ``FLAGS_zb_w_extra_delay`` 0 and 2.
- ``PipelineLayer``: the uniform stage bounds, ``get_stage_from_index``,
  a shared layer built once and called through its ``forward_func``, the
  state-dict keys and the forward of the reference's, weights crossed
  through numpy.
- ``PipelineParallel.train_batch`` / ``eval_batch`` in
  ``tests/test_distributed.py:138``'s setting (four Linear(8, 8), two
  stages, two micro-batches, SGD 0.01, two steps) against the reference's,
  fp32 at 1e-6; ``PipelineParallelWithInterleave``'s contract.
- ``recompute_sequential`` against the reference's: output and gradients.
- One rank (a ``Group`` of one, no process group): ZeroBubble runs F = B
  = W = m with one stage forward a micro-batch, against the reference's
  ZeroBubble on its one-rank stub (``tests/test_zb_split.py``); VPP at one
  stage hands its chunk-to-chunk activations through the local FIFO, no
  P2P, against the reference's single-process four-stage model.
- The transport's card branch, run on the CPU over a fake wire with the
  ranks as threads (``_CardWire``): payloads held and issued with the
  next receive through ``batch_isend_irecv``, and no host read of a loss
  while a payload the rank receives is still held by its sender (on a
  card that read deadlocks two stages). 1F1B, FThenB, ZeroBubble and VPP
  against the reference's loss and gradients; the wire catches a
  mid-schedule loss read.
- ``build_pipeline_runtime``'s dispatch and errors, the in-flight cap and
  stash warning flags, the sanitizer gate, and ``fleet.distributed_model``
  in pipeline mode without a process group (``PipelineParallel``).
"""
import collections
import importlib
import threading
import types
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as ref
import paddle_tpu.distributed.pipeline as rpipe
import paddle_tpu_torch as pt
from paddle_tpu._core import flags as ref_flags
from paddle_tpu_torch._core import device as pt_device
from paddle_tpu_torch._core import flags as pt_flags
from paddle_tpu_torch.distributed import pipeline as ppipe
from paddle_tpu_torch.distributed.process_group import Group

# each fleet package binds ``recompute`` to the function: the modules by path
rrecompute = importlib.import_module("paddle_tpu.distributed.fleet.recompute")
precompute = importlib.import_module(
    "paddle_tpu_torch.distributed.fleet.recompute")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(pt_device, "_current", "cpu")


def _np(t):
    return np.array(t.numpy())


def _cross(ref_layer, pt_layer):
    pt_layer.set_state_dict({k: _np(v)
                             for k, v in ref_layer.state_dict().items()})


# ------------------------------------------------------------ schedules

@pytest.mark.parametrize("schedule", ["1F1B", "FThenB"])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_fb_schedule_is_the_reference_s(schedule, P):
    for m in range(1, 9):
        for r in range(P):
            assert ppipe._fb_schedule(r, P, m, schedule) == \
                rpipe._fb_schedule(r, P, m, schedule), (r, m)


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_interleave_schedule_is_the_reference_s(C, P):
    for m in range(1, 13):
        for r in range(P):
            try:
                want = rpipe._interleave_schedule(r, P, C, m)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    ppipe._interleave_schedule(r, P, C, m)
                assert str(got.value) == str(e)
                continue
            assert ppipe._interleave_schedule(r, P, C, m) == want, (r, m)


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_zero_bubble_schedule_is_the_reference_s(delay, P):
    ref_flags.set_flags({"FLAGS_zb_w_extra_delay": delay})
    pt_flags.set_flags({"FLAGS_zb_w_extra_delay": delay})
    try:
        for m in range(1, 9):
            for r in range(P):
                assert ppipe._zero_bubble_schedule(r, P, m) == \
                    rpipe._zero_bubble_schedule(r, P, m), (r, m)
    finally:
        ref_flags.set_flags({"FLAGS_zb_w_extra_delay": 0})
        pt_flags.set_flags({"FLAGS_zb_w_extra_delay": 0})


# ------------------------------------------------------- PipelineLayer

def _tied(P):
    """Linear(8, 8) tied as its own transpose at the end, around five
    Linear(8, 8): the shared-layer pattern of a tied embedding."""
    def head(layer, x):
        return P.matmul(x, layer.weight, transpose_y=True)

    nn = P.nn
    return ([P.distributed.SharedLayerDesc("tied", nn.Linear, None,
                                           "weight", 8, 8)]
            + [P.distributed.LayerDesc(nn.Linear, 8, 8) for _ in range(5)]
            + [P.distributed.SharedLayerDesc("tied", nn.Linear, head,
                                             "weight", 8, 8)])


@pytest.mark.parametrize("num_stages", [1, 2, 3, 4])
def test_pipeline_layer_stages_and_shared_layers(num_stages):
    rl = ref.distributed.PipelineLayer(_tied(ref), num_stages=num_stages)
    pl = pt.distributed.PipelineLayer(_tied(pt), num_stages=num_stages)
    assert pl._stage_bounds == rl._stage_bounds
    for i in range(len(rl.run_functions) + 1):
        assert pl.get_stage_from_index(i) == rl.get_stage_from_index(i)
    for s in range(num_stages):
        assert len(pl.stage_layers(s)) == len(rl.stage_layers(s))
    assert pl.run_functions[0] is pl.run_functions[-1]
    assert list(pl.state_dict()) == list(rl.state_dict())
    assert len(pl.parameters()) == len(rl.parameters()) == 12
    _cross(rl, pl)
    x = np.random.RandomState(0).randn(3, 8).astype("float32")
    np.testing.assert_allclose(pl(pt.to_tensor(x)).numpy(),
                               rl(ref.to_tensor(x)).numpy(), rtol=1e-6,
                               atol=1e-6)
    # one stage's layers as one Layer, the tied head through its func
    whole = pl._segment(0, len(pl.run_functions))
    np.testing.assert_array_equal(whole(pt.to_tensor(x)).numpy(),
                                  pl(pt.to_tensor(x)).numpy())


def _pp_pair(accumulate_steps=2):
    """test_distributed.py:138's model in both packages, weights crossed,
    wrapped in PipelineParallel."""
    from paddle_tpu.distributed.fleet.strategy import \
        DistributedStrategy as RS
    from paddle_tpu_torch.distributed.fleet.strategy import \
        DistributedStrategy as PS
    out = []
    for P, S in ((ref, RS), (pt, PS)):
        layer = P.distributed.PipelineLayer(
            layers=[P.distributed.LayerDesc(P.nn.Linear, 8, 8)
                    for _ in range(4)],
            num_stages=2, loss_fn=P.nn.functional.mse_loss)
        strategy = S()
        strategy.pipeline_configs["accumulate_steps"] = accumulate_steps
        out.append((P, layer, strategy))
    _cross(out[0][1], out[1][1])
    return out


def test_pipeline_parallel_train_and_eval_match_the_reference():
    r = np.random.RandomState(2)
    x, y = r.rand(4, 8).astype("float32"), r.rand(4, 8).astype("float32")
    got = []
    for P, layer, strategy in _pp_pair():
        pp = P.distributed.PipelineParallel(layer, None, strategy)
        opt = P.optimizer.SGD(0.01, parameters=layer.parameters())
        data = [P.to_tensor(x), P.to_tensor(y)]
        losses = [float(pp.train_batch(data, opt)) for _ in range(2)]
        params = [_np(p) for p in layer.parameters()]
        ev = float(pp.eval_batch(data))
        last = _np(pp.eval_batch(data, compute_loss=False))
        got.append((losses, params, ev, last))
    (rl, rp, re, rlast), (ml, mp, me, mlast) = got
    np.testing.assert_allclose(ml, rl, rtol=1e-6)
    assert ml[1] < ml[0]
    for a, b in zip(mp, rp):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(me, re, rtol=1e-6)
    np.testing.assert_allclose(mlast, rlast, rtol=1e-6, atol=1e-6)
    assert mlast.shape == (2, 8)


def test_interleave_wrapper_contract_and_chunks():
    for steps in (3, 2):
        for P, layer, strategy in _pp_pair(steps):
            with pytest.raises(ValueError, match="multiple of"):
                P.distributed.PipelineParallelWithInterleave(
                    layer, None, strategy, num_virtual_pipeline_stages=2)
    (_, rlayer, rs), (_, player, ps) = _pp_pair(4)
    rw = ref.distributed.PipelineParallelWithInterleave(rlayer, None, rs)
    pw = pt.distributed.PipelineParallelWithInterleave(player, None, ps)
    assert pw._virtual_bounds == rw._virtual_bounds
    for s in range(2):
        for c in range(2):
            assert len(pw.virtual_stage_layers(s, c)) == \
                len(rw.virtual_stage_layers(s, c))


def test_recompute_sequential_matches_the_reference():
    x = np.random.RandomState(4).randn(4, 8).astype("float32")
    got = []
    for P, rec in ((ref, rrecompute), (pt, precompute)):
        P.seed(3)
        nn = P.nn
        net = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 8),
                            nn.Tanh(), nn.Linear(8, 8))
        if P is pt:
            _cross(got[0][0], net)
        xt = P.to_tensor(x)
        xt.stop_gradient = False
        out = rec.recompute_sequential({"segments": 2}, net, xt)
        (out * out).sum().backward()
        got.append((net, _np(out), _np(xt.grad),
                    [_np(p.grad) for p in net.parameters()]))
    (_, ro, rx, rg), (_, mo, mx, mg) = got
    np.testing.assert_allclose(mo, ro, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(mx, rx, rtol=1e-5, atol=1e-6)
    for a, b in zip(mg, rg):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------- one-rank runtimes

class _StubPG:
    rank = 0
    size = 1

    def barrier(self):
        pass


class _StubGroup:
    pg = _StubPG()


def _micro(P, xs):
    return [P.to_tensor(a) for a in xs]


def test_zero_bubble_runs_one_forward_per_micro_batch():
    """tests/test_zb_split.py at one rank: F = B = W = M, one stage
    forward a micro-batch, the reference's loss and gradients."""
    M = 3
    r = np.random.RandomState(3)
    xs = [r.randn(4, 8).astype("float32") for _ in range(M)]
    ys = [r.randn(4, 8).astype("float32") for _ in range(M)]
    ref.seed(11)
    rstage = ref.nn.Sequential(ref.nn.Linear(8, 16), ref.nn.ReLU(),
                               ref.nn.Linear(16, 8))
    rrt = rpipe.DistPipelineRuntimeZB(rstage, _StubGroup(),
                                      ref.nn.functional.mse_loss, M)
    rloss = rrt.train_batch(_micro(ref, xs), _micro(ref, ys))
    stage = pt.nn.Sequential(pt.nn.Linear(8, 16), pt.nn.ReLU(),
                             pt.nn.Linear(16, 8))
    _cross(rstage, stage)
    calls = []
    stage.register_forward_post_hook(lambda *_: calls.append(1))
    rt = ppipe.DistPipelineRuntimeZB(stage, Group([0]),
                                     pt.nn.functional.mse_loss, M)
    loss = rt.train_batch(_micro(pt, xs), _micro(pt, ys))
    assert rt.counts == rrt.counts == {"F": M, "B": M, "W": M}
    assert rt.executed == rrt.executed and len(calls) == M
    np.testing.assert_allclose(loss, rloss, rtol=1e-6)
    for p, q in zip(stage.parameters(), rstage.parameters()):
        np.testing.assert_allclose(_np(p.grad), _np(q.grad), rtol=1e-5,
                                   atol=1e-6)


def _four_stage_reference(ws, bs, x, y, m):
    """The reference's single-process model: relu(Linear) stages, m
    micro-batches, loss mse / m accumulated."""
    F = ref.nn.functional
    lins = []
    for w, b in zip(ws, bs):
        lin = ref.nn.Linear(*w.shape)
        lin.set_state_dict({"weight": w, "bias": b})
        lins.append(lin)
    total, mb = 0.0, x.shape[0] // m
    for i in range(m):
        h = ref.to_tensor(x[i * mb:(i + 1) * mb])
        for lin in lins:
            h = F.relu(lin(h))
        loss = F.mse_loss(h, ref.to_tensor(y[i * mb:(i + 1) * mb])) / m
        loss.backward()
        total += float(loss.numpy())
    return total, [[_np(l.weight.grad), _np(l.bias.grad)] for l in lins]


def test_vpp_at_one_stage_hands_over_through_the_local_fifo():
    import torch_dist_ranks as W
    r = np.random.RandomState(5)
    ws = [(r.randn(8, 8) * 0.4).astype("float32") for _ in range(2)]
    bs = [(r.randn(8) * 0.1).astype("float32") for _ in range(2)]
    x, y = r.randn(8, 8).astype("float32"), r.randn(8, 8).astype("float32")
    rloss, rgrads = _four_stage_reference(ws, bs, x, y, 4)
    chunks = [W._relu_linear(pt, w, b) for w, b in zip(ws, bs)]
    rt = ppipe.build_pipeline_runtime(chunks, Group([0]),
                                      pt.nn.functional.mse_loss, 4, "VPP")
    loss = rt.train_batch(_micro(pt, np.split(x, 4)),
                          _micro(pt, np.split(y, 4)))
    assert rt._p2p.sends == 0 and not rt._p2p._local
    np.testing.assert_allclose(loss, rloss, rtol=1e-6)
    for c, want in zip(chunks, rgrads):
        for p, g in zip(c.parameters(), want):
            np.testing.assert_allclose(_np(p.grad), g, rtol=1e-6, atol=1e-6)


class _CardWire:
    """``torch.distributed`` as the card branch of ``_P2P`` meets it, for
    ranks run as threads of one process.

    - A header (``isend``/``irecv`` of the small int64 tensor) is delivered
      at once, as gloo delivers it; any other ``isend`` fails the run.
    - A payload moves only inside ``batch_isend_irecv``. Its ``P2POp``
      hands the data over when it is made (on a card the stream would wait
      for it), but counts as issued only when its batch is.
    - A host read of a port tensor on a rank waits until every payload that
      rank has received was issued: on a card it waits on the device for
      the same thing. A wait longer than ``timeout`` fails: that is the
      card's deadlock."""

    HEADER = 2 + ppipe._MAX_DIMS

    def __init__(self, P, timeout):
        self.cv = threading.Condition()
        self.timeout = timeout
        self.headers = collections.defaultdict(collections.deque)
        self.built = collections.defaultdict(list)   # (src, dst) -> data
        self.issued = collections.Counter()
        self.taken = collections.Counter()
        self.batches = []      # (rank, [("send" | "recv", peer), ...])
        self._barrier = threading.Barrier(P, timeout=timeout)
        wire = self

        class P2POp:
            def __init__(self, op, tensor, peer, group):
                self.op, self.tensor, self.peer = op, tensor, peer
                self.group = group
                if op is wire.isend:
                    with wire.cv:
                        wire.built[(group.rank, peer)].append(tensor)
                        wire.cv.notify_all()

        self.P2POp = P2POp
        # bound once, so that ``op is wire.isend`` tells a send
        self.isend, self.irecv = self._isend, self._irecv

    def _wait(self, ready, what):
        if not self.cv.wait_for(ready, self.timeout):
            raise AssertionError(f"deadlock on the card: {what}")

    def _isend(self, h, peer, group):
        assert h.dtype == torch.int64 and h.numel() == self.HEADER, \
            "a payload went out of a batch"
        with self.cv:
            self.headers[(group.rank, peer)].append(h.clone())
            self.cv.notify_all()
        return _Done()

    def _irecv(self, h, peer, group):
        wire, key = self, (peer, group.rank)

        class Work:
            def wait(self):
                with wire.cv:
                    wire._wait(lambda: wire.headers[key],
                               f"rank {key[1]} waits for a header from "
                               f"rank {peer}")
                    h.copy_(wire.headers[key].popleft())
        return Work()

    def batch_isend_irecv(self, ops):
        me, done = ops[0].group.rank, []
        with self.cv:
            for op in ops:
                if op.op is self.isend:
                    key = (me, op.peer)
                    assert self.built[key][self.issued[key]] is op.tensor
                    self.issued[key] += 1
                    done.append(("send", op.peer))
                else:
                    key, k = (op.peer, me), self.taken[(op.peer, me)]
                    self._wait(lambda: len(self.built[key]) > k,
                               f"rank {me} posts a receive from rank "
                               f"{op.peer} that was never sent")
                    op.tensor.copy_(self.built[key][k])
                    self.taken[key] += 1
                    done.append(("recv", op.peer))
            self.batches.append((me, done))
            self.cv.notify_all()
        return [_Done() for _ in ops]

    def barrier(self, group):
        self._barrier.wait()

    def host_read(self, rank):
        with self.cv:
            self._wait(lambda: all(self.issued[k] >= n
                                   for k, n in self.taken.items()
                                   if k[1] == rank),
                       f"rank {rank} reads a tensor on the host while a "
                       f"payload it receives is held by its sender")


class _Done:
    def wait(self):
        pass


_HOST_READS = ("__float__", "__int__", "__bool__", "item", "numpy",
               "tolist")


def _run_on_card_wire(monkeypatch, schedule, P, m, C=1, timeout=10.0):
    """A P-stage runtime, each rank a thread, through ``_P2P``'s card
    branch over ``_CardWire``: relu(Linear(8, 8)) a virtual stage, loss
    mse, two rows a micro-batch. Returns the wire, the last rank's loss,
    each rank's chunks and the reference's loss and gradients."""
    import torch_dist_ranks as W
    r = np.random.RandomState(9)
    ws = [(r.randn(8, 8) * 0.5).astype("float32") for _ in range(P * C)]
    bs = [(r.randn(8) * 0.1).astype("float32") for _ in range(P * C)]
    x, y = r.randn(2 * m, 8).astype("float32"), \
        r.randn(2 * m, 8).astype("float32")
    wire, here = _CardWire(P, timeout), threading.local()
    monkeypatch.setattr(ppipe, "dist", wire)
    for name in _HOST_READS:
        def read(self, *a, _orig=getattr(pt.Tensor, name), **k):
            if getattr(here, "rank", None) is not None:
                wire.host_read(here.rank)
            return _orig(self, *a, **k)
        monkeypatch.setattr(pt.Tensor, name, read)
    rts, chunks = [], []
    for rank in range(P):
        group = types.SimpleNamespace(ranks=list(range(P)), rank=rank,
                                      nranks=P,
                                      pg=types.SimpleNamespace(rank=rank))
        cs = [W._relu_linear(pt, ws[c * P + rank], bs[c * P + rank])
              for c in range(C)]
        rt = ppipe.build_pipeline_runtime(cs if C > 1 else cs[0], group,
                                          pt.nn.functional.mse_loss, m,
                                          schedule)
        assert not rt._p2p.batched    # a CPU stage: the gloo branch
        rt._p2p.batched = True
        rts.append(rt)
        chunks.append(cs)
    xs, ys = _micro(pt, np.split(x, m)), _micro(pt, np.split(y, m))
    losses, errors = [None] * P, []

    def run(rank):
        here.rank = rank
        try:
            losses[rank] = rts[rank].train_batch(
                xs if rank == 0 else None, ys if rank == P - 1 else None)
        except BaseException as e:   # raised again on the main thread
            errors.append(e)
        finally:
            here.rank = None

    threads = [threading.Thread(target=run, args=(k,)) for k in range(P)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(4 * timeout)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    return (wire, losses[-1], chunks,
            _four_stage_reference(ws, bs, x, y, m))


@pytest.mark.parametrize("schedule,P,C", [
    ("1F1B", 2, 1), ("1F1B", 3, 1), ("FThenB", 2, 1),
    ("ZeroBubble", 2, 1), ("ZeroBubble", 3, 1), ("VPP", 2, 2)])
def test_the_card_branch_reads_no_loss_while_a_send_is_held(
        monkeypatch, schedule, P, C):
    """The card branch of the transport: payloads held and issued with the
    next receive, no host read of a loss before the batch ends. Every
    payload is issued by the end, in a batch, and the loss and gradients
    are the reference's."""
    m = 4
    wire, loss, chunks, (rloss, rgrads) = _run_on_card_wire(
        monkeypatch, schedule, P, m, C)
    hops = {(r, (r + 1) % P) for r in range(P if C > 1 else P - 1)}
    assert set(wire.built) == hops | {(b, a) for a, b in hops}
    for key, sent in wire.built.items():
        assert wire.issued[key] == wire.taken[key] == len(sent) > 0, key
    assert any(len(ops) > 1 for _, ops in wire.batches)
    np.testing.assert_allclose(loss, rloss, rtol=1e-6)
    for rank, cs in enumerate(chunks):
        for c, chunk in enumerate(cs):
            for p, g in zip(chunk.parameters(), rgrads[c * P + rank]):
                np.testing.assert_allclose(_np(p.grad), g, rtol=1e-6,
                                           atol=1e-6)


def test_the_card_wire_catches_a_loss_read_mid_schedule(monkeypatch):
    """The wire's check has teeth: a last stage that reads each loss as it
    is made (what the runtimes did before) deadlocks at two stages."""
    forward = ppipe.DistPipelineRuntime._forward_micro

    def eager_read(self, i, micro_in, label):
        loss = forward(self, i, micro_in, label)
        if loss is not None:
            float(loss)
        return loss

    monkeypatch.setattr(ppipe.DistPipelineRuntime, "_forward_micro",
                        eager_read)
    with pytest.raises(AssertionError, match="deadlock on the card"):
        _run_on_card_wire(monkeypatch, "1F1B", 2, 4, timeout=1.0)


def test_schedule_mode_factory_dispatch():
    stage = pt.nn.Linear(2, 2)
    g = Group([0])
    F = pt.nn.functional.mse_loss
    with pytest.raises(ValueError, match="list of model-chunk"):
        ppipe.build_pipeline_runtime(stage, g, F, 4, schedule="VPP")
    with pytest.raises(ValueError, match="unknown pipeline"):
        ppipe.build_pipeline_runtime(stage, g, F, 4, schedule="nope")
    with pytest.raises(ValueError, match="takes ONE stage"):
        ppipe.build_pipeline_runtime([stage], g, F, 4, schedule="1F1B")
    for mode, cls, sched in (("1F1B", "DistPipelineRuntime", "1F1B"),
                             ("F-then-B", "DistPipelineRuntime", "FThenB"),
                             ("ZBH1", "DistPipelineRuntimeZB", None),
                             ("Interleave", "DistPipelineRuntimeVPP", None)):
        rt = ppipe.build_pipeline_runtime(
            [stage] if cls.endswith("VPP") else stage, g, F, 4, mode)
        assert type(rt).__name__ == cls
        assert getattr(rt, "schedule", None) == sched


def test_in_flight_cap_and_stash_warning():
    stage = pt.nn.Linear(8, 8)
    x = [pt.to_tensor(np.zeros((40000, 8), np.float32))] * 2
    rt = ppipe.build_pipeline_runtime(stage, Group([0]),
                                      pt.nn.functional.mse_loss, 2,
                                      "FThenB")
    pt_flags.set_flags({"FLAGS_pipeline_max_inflight": 1})
    try:
        with pytest.raises(RuntimeError, match="in-flight"):
            rt.train_batch(x, x)
    finally:
        pt_flags.set_flags({"FLAGS_pipeline_max_inflight": 0})
    rt = ppipe.build_pipeline_runtime(stage, Group([0]),
                                      pt.nn.functional.mse_loss, 2, "1F1B")
    pt_flags.set_flags({"FLAGS_pipeline_stash_warn_mb": 1})
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            rt.train_batch(x, x)
    finally:
        pt_flags.set_flags({"FLAGS_pipeline_stash_warn_mb": 0})
    assert any("FLAGS_pipeline_stash_warn_mb" in str(w.message)
               for w in seen)
    assert rt.max_inflight == 1 and rt.max_stash_bytes > 1 << 20


def test_sanitizer_gate_is_off_until_the_flag_exists():
    stage = pt.nn.Linear(2, 2)
    F = pt.nn.functional.mse_loss
    ppipe.build_pipeline_runtime(stage, Group([0]), F, 2, "1F1B")
    pt_flags.define_flag("FLAGS_static_checks", "warn", "test")
    try:
        with pytest.raises(NotImplementedError, match="item 9"):
            ppipe.build_pipeline_runtime(stage, Group([0]), F, 2, "ZB")
        pt_flags.set_flags({"FLAGS_static_checks": "off"})
        ppipe.build_pipeline_runtime(stage, Group([0]), F, 2, "ZB")
    finally:
        del pt_flags._REGISTRY["FLAGS_static_checks"]


def test_distributed_model_without_a_process_group():
    """Pipeline mode with no process group: ``PipelineParallel``, as the
    reference's single controller gives; a model that is not a
    ``PipelineLayer`` comes back itself."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 2, "sharding_degree": 1}
    strategy.pipeline_configs = {"accumulate_steps": 2,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        assert fleet.get_hybrid_communicate_group().get_parallel_mode() \
            == "pipeline"
        layer = pt.distributed.PipelineLayer(
            [pt.nn.Linear(4, 4), pt.nn.Linear(4, 4)], num_stages=2,
            loss_fn=pt.nn.functional.mse_loss)
        pp = fleet.distributed_model(layer)
        assert isinstance(pp, pt.distributed.PipelineParallel)
        assert pp.accumulate_steps == 2
        plain = pt.nn.Linear(4, 4)
        assert fleet.distributed_model(plain) is plain
    finally:
        fleet._forget()
