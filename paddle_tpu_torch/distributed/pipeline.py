"""The eager pipeline: the counterpart of ``paddle_tpu/distributed/
pipeline.py`` (upstream ``pp_layers.py`` ``PipelineLayer`` and
``pipeline_parallel.py`` ``PipelineParallel``).

- ``LayerDesc`` / ``SharedLayerDesc`` / ``PipelineLayer``: the model as a
  list of layers cut into uniform stages; a shared layer (a tied
  embedding) is built once and, where its desc has a ``forward_func``,
  called through it.
- ``PipelineParallel``: one process runs the whole model, micro-batch by
  micro-batch (loss / m, gradients accumulated), then one optimizer step:
  the numbers of the 1F1B schedule, which only reorders that work.
- ``DistPipelineRuntime`` (1F1B, FThenB), ``DistPipelineRuntimeVPP``
  (interleaved 1F1B) and ``DistPipelineRuntimeZB`` (ZeroBubble ZB-H1):
  one stage per rank of a process group, activations and gradients moved
  point to point. The schedules are the reference's pure functions,
  ``_fb_schedule``, ``_interleave_schedule`` and
  ``_zero_bubble_schedule``, token for token.

The transport (``_P2P``) moves tensors device to device with
``torch.distributed`` and never blocks a send, which the schedules need:
the reference's send is a store put that does not wait for the receiver,
and a send that waits deadlocks 1F1B at two stages (each rank sends, then
waits for the other to receive). A send is posted with ``isend`` and its
handle kept until the barrier that ends ``train_batch``; a receive learns
its shape and dtype from a small header (a CPU tensor, over gloo) sent
just before the payload. On a card the payload sends wait and go out with
the next receive in one ``batch_isend_irecv``, so a pair's send and
receive are issued together on the communicator's stream. A held send
goes out only when its rank next receives, and that receive first waits on
the host for a header the peer sends later in its schedule. So no runtime
makes a host-blocking call (``float`` of a loss) before ``_end_batch``:
it would wait on the device for a payload that the peer still holds, and
the peer would wait for this rank's next header. Each micro-batch's loss
stays a tensor until the batch has ended. Ranks are global in
``torch.distributed``: a stage index maps through ``group.ranks``. A send
to this rank itself (VPP's chunk-to-chunk hop at one stage) goes through a
local FIFO.

ZeroBubble splits each micro-batch's backward without a second forward:
F runs the stage once and keeps its graph; B is ``torch.autograd.grad(out,
[x_in], g, retain_graph=True)`` (the input gradient, sent upstream; none at
the first stage, whose input is ids); W is ``torch.autograd.grad(out,
params, g)``, added into each ``p.grad``. W walks the activation-gradient
chain again on its way to the weights, as the reference's split pullback
keeps it for ``dparams``.

The reference runs its program sanitizer over each runtime's schedule when
``FLAGS_static_checks`` is on; that checker and the flag are the analysis
plane's (``ROADMAP.md`` §1 item 9): until the port defines the flag the
gate is off, and a level other than off raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
from typing import List

import torch
import torch.distributed as dist

from .._core.autograd import backward as _backward
from .._core.autograd import no_grad
from .._core.flags import flag_value
from .._core.tensor import Tensor
from ..nn.layer import Layer
from ..nn.layers_common import LayerList


class LayerDesc:
    """Deferred layer constructor (pp_layers.py:57)."""

    def __init__(self, layer_class, *args, **kwargs):
        self.layer_class = layer_class
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_class(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_class.__name__})"


class SharedLayerDesc(LayerDesc):
    """Layer shared between stages, e.g. tied embeddings (pp_layers.py:77)."""

    def __init__(self, key, layer_class, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_class, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class _Segment(Layer):
    """Consecutive layers of a ``PipelineLayer`` run in order, each through
    its ``forward_func`` where its desc gave one: one rank's stage, or one
    VPP chunk."""

    def __init__(self, layers, forward_funcs):
        super().__init__()
        self.run_functions = LayerList(list(layers))
        self._forward_funcs = list(forward_funcs)

    def forward(self, x):
        for layer, ffunc in zip(self.run_functions, self._forward_funcs):
            x = layer(x) if ffunc is None else ffunc(layer, x)
        return x


class PipelineLayer(Layer):
    """Stage-segmented model container (pp_layers.py:264)."""

    def __init__(self, layers, num_stages=None, topology=None,
                 loss_fn=None, seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._loss_fn = loss_fn
        self._num_stages = num_stages or 1
        self._topology = topology
        self.recompute_interval = recompute_interval
        descs = list(layers)
        self._shared_layers = {}
        built: List = []
        for d in descs:
            if isinstance(d, SharedLayerDesc):
                if d.layer_name not in self._shared_layers:
                    self._shared_layers[d.layer_name] = d.build_layer()
                built.append((self._shared_layers[d.layer_name],
                              d.forward_func))
            elif isinstance(d, LayerDesc):
                built.append((d.build_layer(), None))
            else:
                built.append((d, None))
        self.run_functions = LayerList([l for l, _ in built])
        self._forward_funcs = [f for _, f in built]
        # stage segmentation (uniform by layer count, seg_method analog)
        n = len(built)
        per = max(n // self._num_stages, 1)
        self._stage_bounds = [
            (i * per, (i + 1) * per if i < self._num_stages - 1 else n)
            for i in range(self._num_stages)]

    def get_stage_from_index(self, idx):
        for s, (lo, hi) in enumerate(self._stage_bounds):
            if lo <= idx < hi:
                return s
        return self._num_stages - 1

    forward = _Segment.forward

    def stage_layers(self, stage_id):
        lo, hi = self._stage_bounds[stage_id]
        return self.run_functions[lo:hi]

    def _segment(self, lo, hi) -> Layer:
        """Layers ``lo:hi`` as one Layer that honours the shared layers'
        ``forward_func`` (the reference's ``Sequential`` of
        ``stage_layers`` calls a tied head as an embedding)."""
        layers = list(self.run_functions)
        return _Segment(layers[lo:hi], self._forward_funcs[lo:hi])


class PipelineParallel(Layer):
    """Micro-batched pipeline runtime (pipeline_parallel.py:242).

    train_batch(data, optimizer, scaler) splits the batch into
    accumulate_steps micro-batches, accumulates grads, then steps — the
    1F1B schedule's numerics."""

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        cfg = strategy.pipeline_configs if strategy is not None else None
        self.accumulate_steps = cfg["accumulate_steps"] if cfg else 1
        self.micro_batch_size = cfg["micro_batch_size"] if cfg else 1

    def forward(self, x):
        return self._layers(x)

    def _split_micro(self, data):
        inputs, labels = data
        total = inputs.shape[0]
        m = self.accumulate_steps
        mb = max(total // m, 1)
        micros = []
        for i in range(m):
            lo = i * mb
            hi = min(lo + mb, total)
            if lo >= total:
                break
            micros.append((inputs[lo:hi], labels[lo:hi]))
        return micros

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        micros = self._split_micro(data)
        total_loss = None
        for x, y in micros:
            out = self._layers(x)
            loss = self._layers._loss_fn(out, y)
            scaled = loss / len(micros)
            if scaler is not None:
                scaler.scale(scaled).backward()
            else:
                scaled.backward()
            total_loss = scaled.detach() if total_loss is None else \
                total_loss + scaled.detach()
        if scaler is not None:
            scaler.step(optimizer)
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return total_loss

    def eval_batch(self, data, compute_loss=True):
        micros = self._split_micro(data)
        total = None
        with no_grad():
            for x, y in micros:
                out = self._layers(x)
                if compute_loss:
                    loss = self._layers._loss_fn(out, y) / len(micros)
                    total = loss if total is None else total + loss
                else:
                    total = out
        return total


# ------------------------------------------------------------ transport

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
           torch.bool)
_MAX_DIMS = 8


class _P2P:
    """Point-to-point transport of one pipeline runtime over its group
    (see the module docstring): sends never wait for their receiver."""

    def __init__(self, group, device):
        self.ranks = list(group.ranks)
        self.me = self.ranks[group.rank]
        self.pg = group.pg
        # on a card payloads are held and issued with the next receive
        self.batched = torch.device(device).type == "cuda"
        self._local = collections.deque()  # sends to this rank itself
        self._posted = []    # (work, tensor) of sends in flight
        self._held = []      # a card's payload sends, for the next receive
        self.sends = 0       # P2P sends to another rank (headers apart)

    def _header(self, t: torch.Tensor) -> torch.Tensor:
        if t.dim() > _MAX_DIMS:
            raise ValueError(f"a pipeline stage output has {t.dim()} dims; "
                             f"the transport carries up to {_MAX_DIMS}")
        h = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
        h[0], h[1] = _DTYPES.index(t.dtype), t.dim()
        h[2:2 + t.dim()] = torch.tensor(t.shape, dtype=torch.int64)
        return h

    def send(self, t: torch.Tensor, dst: int) -> None:
        """``t`` to stage index ``dst`` of the group."""
        t = t.detach().contiguous()
        peer = self.ranks[dst]
        if peer == self.me:
            self._local.append(t)
            return
        h = self._header(t)
        self._posted.append((dist.isend(h, peer, group=self.pg), h))
        self.sends += 1
        if self.batched:
            self._held.append(dist.P2POp(dist.isend, t, peer, group=self.pg))
        else:
            self._posted.append((dist.isend(t, peer, group=self.pg), t))

    def recv(self, src: int, device) -> torch.Tensor:
        """The next tensor stage index ``src`` sent to this rank."""
        peer = self.ranks[src]
        if peer == self.me:
            return self._local.popleft()
        h = torch.empty(2 + _MAX_DIMS, dtype=torch.int64)
        dist.irecv(h, peer, group=self.pg).wait()
        shape = [int(d) for d in h[2:2 + int(h[1])]]
        buf = torch.empty(shape, dtype=_DTYPES[int(h[0])], device=device)
        if self.batched:
            ops = self._held + [dist.P2POp(dist.irecv, buf, peer,
                                           group=self.pg)]
            works = dist.batch_isend_irecv(ops)
            self._posted += [(w, op.tensor) for w, op in
                             zip(works[:-1], self._held)]
            self._held = []
            works[-1].wait()
        else:
            dist.irecv(buf, peer, group=self.pg).wait()
        return buf

    def finish(self) -> None:
        """Issues the sends still held and waits for every send."""
        if self._held:
            works = dist.batch_isend_irecv(self._held)
            self._posted += [(w, op.tensor) for w, op in
                             zip(works, self._held)]
            self._held = []
        for w, _ in self._posted:
            w.wait()
        self._posted = []


def _device_of(layers) -> torch.device:
    for layer in layers:
        for p in layer.parameters():
            return p._t.device
    from .._core.device import default_device
    return default_device()


def _nbytes(t) -> int:
    if t is None:
        return 0
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    if isinstance(t, Tensor):
        t = t._t
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return 0


class _HostPipeBase:
    """Shared plumbing for the host-driven multi-process pipeline
    runtimes (1F1B/FThenB, VPP, ZeroBubble): group wiring, stash
    + memory accounting, zero-grad P2P fallback, and micro-batch count
    validation — one implementation so the schedules can't drift."""

    def __init__(self, group, loss_fn, num_microbatches: int, layers):
        if group.rank < 0:
            raise ValueError(f"this rank is not a member of the pipeline "
                             f"group {group}")
        self.group = group
        self.pg = group.pg
        self.rank = group.rank
        self.num_stages = group.nranks
        self.P = group.nranks
        self.loss_fn = loss_fn
        self.m = int(num_microbatches)
        self._stash = {}
        self.max_inflight = 0
        self.max_stash_bytes = 0
        self.device = _device_of(layers)
        self._p2p = _P2P(group, self.device)

    def _track(self, extra=()):
        n = len(self._stash) + sum(len(d) for d in extra)
        self.max_inflight = max(self.max_inflight, n)
        cap = flag_value("FLAGS_pipeline_max_inflight")
        if cap and n > cap:
            raise RuntimeError(
                f"pipeline rank {self.rank}: {n} in-flight micro-batch "
                f"stashes exceed FLAGS_pipeline_max_inflight={cap}")
        live = sum(_nbytes(vals) for d in (self._stash,) + tuple(extra)
                   for vals in d.values())
        self.max_stash_bytes = max(self.max_stash_bytes, live)
        warn_mb = flag_value("FLAGS_pipeline_stash_warn_mb")
        if warn_mb and live > warn_mb * (1 << 20):
            import warnings
            warnings.warn(
                f"pipeline rank {self.rank}: activation stash "
                f"{live / (1 << 20):.1f} MB exceeds "
                f"FLAGS_pipeline_stash_warn_mb={warn_mb}")

    def _static_check_schedule(self, schedule: str, num_chunks: int = 1):
        """The reference's sanitizer gate: with ``FLAGS_static_checks``
        on, it simulates this runtime's schedule for deadlock before the
        first batch. The flag and the checker are ``ROADMAP.md`` §1 item
        9's; the port has neither yet, so the gate is off while the flag
        is undefined."""
        from .._core import flags as _flags
        level = _flags._REGISTRY.get("FLAGS_static_checks")
        if level is None or level.value == "off":
            return
        raise NotImplementedError(
            f"FLAGS_static_checks={level.value!r}: the pipeline schedule "
            f"checker ({schedule}, P={self.P}, m={self.m}, "
            f"chunks={num_chunks}) is the analysis plane's, ROADMAP.md §1 "
            f"item 9; not ported yet")

    def _recv_input(self, src):
        buf = self._p2p.recv(src, self.device)
        return Tensor(buf, stop_gradient=not buf.is_floating_point())

    def _grad_payload(self, x_in):
        """Input grad to send upstream; zeros keep the P2P protocol
        symmetric when the input turned out disconnected."""
        g = x_in._t.grad
        return torch.zeros_like(x_in._t) if g is None else g

    def _check_micros(self, micro_inputs, micro_labels, need_inputs,
                      need_labels):
        """Fail fast on a bad micro count — mid-schedule IndexErrors
        would leave peer ranks blocked in recv until the dist timeout."""
        if need_inputs and (micro_inputs is None
                            or len(micro_inputs) != self.m):
            raise ValueError(
                f"rank {self.rank} needs exactly num_microbatches="
                f"{self.m} micro_inputs, got "
                f"{None if micro_inputs is None else len(micro_inputs)}")
        if need_labels and (micro_labels is None
                            or len(micro_labels) != self.m):
            raise ValueError(
                f"rank {self.rank} needs exactly num_microbatches="
                f"{self.m} micro_labels, got "
                f"{None if micro_labels is None else len(micro_labels)}")

    def _end_batch(self, losses):
        """Issues and waits for every send, meets the group at a barrier,
        and only then reads the micro-batches' losses on the host (the
        module docstring says why not earlier)."""
        self._p2p.finish()
        if self.pg is not None:
            dist.barrier(group=self.pg)
        return sum(float(l) for l in losses)


def _fb_schedule(rank: int, pp_size: int, num_micro: int,
                 schedule: str = "1F1B"):
    """Per-rank action list for the flat F/B schedules, the definition
    DistPipelineRuntime.train_batch executes. Returns
    [("F"|"B", micro), ...]."""
    P, m = pp_size, num_micro
    if schedule == "FThenB":
        return [("F", i) for i in range(m)] + \
               [("B", i) for i in range(m)]
    # 1F1B (pipeline_parallel.py:684)
    warmup = min(P - rank - 1, m)
    acts = [("F", i) for i in range(warmup)]
    for j in range(m - warmup):
        acts.append(("F", warmup + j))
        acts.append(("B", j))
    for j in range(m - warmup, m):
        acts.append(("B", j))
    return acts


class DistPipelineRuntime(_HostPipeBase):
    """Host-driven multi-process pipeline schedules (pipeline_parallel.py:
    684 forward_backward_pipeline / 1F1B; p2p activations as
    pp_utils/p2p_communication.py:52).

    Each rank owns one stage (a Layer). ``train_batch`` runs the chosen
    schedule; FThenB stashes all M micro-batch activations before any
    backward, 1F1B caps in-flight stashes at num_stages - stage_id, which
    is the measurable memory win (``max_inflight`` / ``max_stash_bytes``).
    """

    def __init__(self, stage_layer: Layer, group, loss_fn,
                 num_microbatches: int, schedule: str = "1F1B"):
        super().__init__(group, loss_fn, num_microbatches, [stage_layer])
        self.stage = stage_layer
        if schedule not in ("1F1B", "FThenB"):
            raise ValueError(f"unknown schedule {schedule}")
        self.schedule = schedule
        self.is_first = self.rank == 0
        self.is_last = self.rank == self.num_stages - 1
        self._static_check_schedule(schedule)

    def _forward_micro(self, i, micro_in, label):
        if self.is_first:
            x_in = micro_in.detach()  # do not mutate the caller's tensor
        else:
            x_in = self._recv_input(self.rank - 1)
        out = self.stage(x_in)
        if self.is_last:
            loss = self.loss_fn(out, label) / self.m
            self._stash[i] = (x_in, loss)
            self._track()
            return loss
        self._stash[i] = (x_in, out)
        self._track()
        self._p2p.send(out._t, self.rank + 1)
        return None

    def _backward_micro(self, i):
        x_in, out = self._stash.pop(i)
        if self.is_last:
            out.backward()  # out is the scaled loss
        else:
            dout = self._p2p.recv(self.rank + 1, self.device)
            _backward([out], [Tensor(dout)])
        if not self.is_first:
            self._p2p.send(self._grad_payload(x_in), self.rank - 1)

    # ------------------------------------------------------------ schedule
    def train_batch(self, micro_inputs=None, micro_labels=None):
        """Run one batch. Rank 0 supplies micro_inputs (list of M input
        Tensors); the last rank supplies micro_labels. Returns the batch
        loss on the last rank (None elsewhere)."""
        self._check_micros(micro_inputs, micro_labels,
                           self.is_first, self.is_last)
        losses: List[Tensor] = []
        for kind, i in _fb_schedule(self.rank, self.num_stages, self.m,
                                    self.schedule):
            if kind == "F":
                x = micro_inputs[i] if self.is_first else None
                y = micro_labels[i] if self.is_last else None
                loss = self._forward_micro(i, x, y)
                if loss is not None:
                    losses.append(loss.detach())
            else:
                self._backward_micro(i)
        total = self._end_batch(losses)
        return total if self.is_last else None


class PipelineParallelWithInterleave(PipelineParallel):
    """VPP single-controller wrapper (pipeline_parallel.py:1308).

    Enforces the interleave contract (accumulate_steps must be a
    multiple of num_stages and ≥ 2·num_stages,
    pipeline_parallel.py:1367) and segments the model into
    num_stages × num_virtual_pipeline_stages virtual chunks. In one
    process the chunks run in dependency order (numerics are
    schedule-independent); the real interleaved schedule across
    processes is DistPipelineRuntimeVPP below.
    """

    def __init__(self, layers: PipelineLayer, hcg=None, strategy=None,
                 num_virtual_pipeline_stages: int = 2):
        super().__init__(layers, hcg=hcg, strategy=strategy)
        self.num_model_chunks = int(num_virtual_pipeline_stages)
        stages = layers._num_stages
        if self.accumulate_steps % stages != 0 \
                or self.accumulate_steps < 2 * stages:
            raise ValueError(
                f"interleaved pipeline needs accumulate_steps "
                f"({self.accumulate_steps}) to be a multiple of "
                f"num_stages ({stages}) and >= 2*num_stages")
        # virtual stage bounds: num_stages * chunks uniform segments
        n = len(layers.run_functions)
        v = stages * self.num_model_chunks
        per = max(n // v, 1)
        self._virtual_bounds = [
            (i * per, (i + 1) * per if i < v - 1 else n)
            for i in range(v)]

    def virtual_stage_layers(self, stage_id: int, chunk_id: int):
        """Layers of virtual stage chunk_id*num_stages + stage_id."""
        v = chunk_id * self._layers._num_stages + stage_id
        lo, hi = self._virtual_bounds[v]
        return self._layers.run_functions[lo:hi]


def _interleave_schedule(rank: int, pp_size: int, num_chunks: int,
                         num_micro: int):
    """Per-rank action list for interleaved 1F1B (VPP).

    The unit mapping is the reference's virtual-pp-rank computation
    (pipeline_parallel.py:1308 _get_virtual_pp_rank): forward unit k
    maps to chunk (k % (P*C)) // P and micro (k // (P*C)) * P + k % P;
    backward chunks run in reverse. Warmup = (P-r-1)*2 + (C-1)*P units.
    Returns [("F"|"B", chunk, micro), ...].
    """
    P, C, m = pp_size, num_chunks, num_micro
    # the reference's interleave contract (pipeline_parallel.py:1367)
    if m % P != 0 or m < 2 * P:
        raise ValueError(
            f"interleave needs num_microbatches ({m}) to be a multiple "
            f"of pp group size ({P}) and >= 2*pp")
    total = m * C

    def funit(k):
        g = k % (P * C)
        return g // P, (k // (P * C)) * P + k % P

    def bunit(k):
        g = k % (P * C)
        return C - 1 - g // P, (k // (P * C)) * P + k % P

    warmup = min(total, (P - rank - 1) * 2 + (C - 1) * P)
    acts = [("F",) + funit(k) for k in range(warmup)]
    for j in range(total - warmup):
        acts.append(("F",) + funit(warmup + j))
        acts.append(("B",) + bunit(j))
    for j in range(total - warmup, total):
        acts.append(("B",) + bunit(j))
    return acts


class DistPipelineRuntimeVPP(_HostPipeBase):
    """Host-driven interleaved-1F1B (VPP) runtime over real processes.

    Each rank owns ``num_chunks`` model chunks; virtual stage
    v = chunk*P + rank. Activations flow rank r → (r+1)%P (the %P
    wraparound carries chunk transitions last-rank → rank 0), gradients
    the reverse — the reference's four-directions P2P
    (four_directions_p2p_communication.py). Per directed pair the
    send/recv sequences are FIFO-consistent projections of the global
    interleave schedule.
    """

    def __init__(self, chunk_layers: List[Layer], group, loss_fn,
                 num_microbatches: int):
        super().__init__(group, loss_fn, num_microbatches, chunk_layers)
        self.chunks = list(chunk_layers)
        self.C = len(self.chunks)
        self.V = self.P * self.C
        self._static_check_schedule("VPP", num_chunks=self.C)

    def _vstage(self, chunk):
        return chunk * self.P + self.rank

    def _forward(self, chunk, i, micro_inputs, micro_labels, losses):
        v = self._vstage(chunk)
        if v == 0:
            x_in = micro_inputs[i].detach()
        else:
            x_in = self._recv_input((self.rank - 1) % self.P)
        out = self.chunks[chunk](x_in)
        if v == self.V - 1:
            loss = self.loss_fn(out, micro_labels[i]) / self.m
            self._stash[(chunk, i)] = (x_in, loss)
            self._track()
            losses.append(loss.detach())
        else:
            self._stash[(chunk, i)] = (x_in, out)
            self._track()
            self._p2p.send(out._t, (self.rank + 1) % self.P)

    def _backward(self, chunk, i):
        v = self._vstage(chunk)
        x_in, out = self._stash.pop((chunk, i))
        if v == self.V - 1:
            out.backward()  # out is the scaled loss
        else:
            dout = self._p2p.recv((self.rank + 1) % self.P, self.device)
            _backward([out], [Tensor(dout)])
        if v > 0:
            self._p2p.send(self._grad_payload(x_in),
                           (self.rank - 1) % self.P)

    def train_batch(self, micro_inputs=None, micro_labels=None):
        """Returns the batch loss on the rank owning the last virtual
        stage (= last rank), None elsewhere."""
        self._check_micros(micro_inputs, micro_labels,
                           self.rank == 0, self.rank == self.P - 1)
        losses: List[Tensor] = []
        acts = _interleave_schedule(self.rank, self.P, self.C, self.m)
        for kind, chunk, i in acts:
            if kind == "F":
                self._forward(chunk, i, micro_inputs, micro_labels,
                              losses)
            else:
                self._backward(chunk, i)
        total = self._end_batch(losses)
        return total if losses else None


def _zero_bubble_schedule(rank: int, pp_size: int, num_micro: int):
    """Per-rank ZB-H1 action list (pipeline_zero_bubble.py:62,151).

    Splits each micro-batch backward into B (activation grad — unblocks
    the upstream rank) and W (weight grad — pure local work). W units
    are deferred by the rank's warmup depth so they fill the cooldown
    bubble that 1F1B leaves idle. Returns [("F"|"B"|"W", micro), ...].
    """
    P, m = pp_size, num_micro
    wf = min(P - rank - 1, m)
    delay = P - rank - 1 + flag_value("FLAGS_zb_w_extra_delay")
    acts = [("F", i) for i in range(wf)]
    w_done = 0
    for j in range(m - wf):
        acts.append(("F", wf + j))
        acts.append(("B", j))
        if j >= delay:
            acts.append(("W", w_done))
            w_done += 1
    for j in range(m - wf, m):
        acts.append(("B", j))
        if w_done < m:
            acts.append(("W", w_done))
            w_done += 1
    while w_done < m:
        acts.append(("W", w_done))
        w_done += 1
    return acts


class DistPipelineRuntimeZB(_HostPipeBase):
    """Host-driven ZeroBubble (ZB-H1) pipeline over real processes.

    The reference splits matmul_grad into its activation-grad and
    weight-grad halves (passes/pipeline_scheduler_pass/
    pipeline_zero_bubble.py:62). Here, per micro-batch: exactly one
    forward (F), whose graph is kept; B takes the input gradient from it
    (``retain_graph``) and sends it upstream; W takes the parameter
    gradients from the same graph and adds them into ``p.grad``. The
    optimizer step must follow the full schedule, as in the reference
    where W ops are reordered before opt. ``counts`` and ``executed``
    record what ran.
    """

    def __init__(self, stage_layer: Layer, group, loss_fn,
                 num_microbatches: int):
        super().__init__(group, loss_fn, num_microbatches, [stage_layer])
        self.stage = stage_layer
        self.is_first = self.rank == 0
        self.is_last = self.rank == self.P - 1
        self._params = list(stage_layer.parameters())
        # _stash: i -> (x_in, out) until B; _w_stash: i -> (out, g)
        # until W
        self._w_stash = {}
        self.executed: List[tuple] = []  # action trace for tests
        self.counts = {"F": 0, "B": 0, "W": 0}  # probe for tests
        self._static_check_schedule("ZeroBubble")

    def _f(self, i, micro_inputs, micro_labels, losses):
        if self.is_first:
            x_in = micro_inputs[i].detach()
        else:
            x_in = self._recv_input(self.rank - 1)
        out = self.stage(x_in)
        if self.is_last:
            out = self.loss_fn(out, micro_labels[i]) / self.m
            losses.append(out.detach())
        else:
            self._p2p.send(out._t, self.rank + 1)
        self._stash[i] = (x_in, out)

    def _b(self, i):
        x_in, out = self._stash.pop(i)
        g = None if self.is_last else \
            self._p2p.recv(self.rank + 1, self.device)
        if not self.is_first:
            if x_in._t.requires_grad:
                dx, = torch.autograd.grad(out._t, [x_in._t], g,
                                          retain_graph=True)
            else:
                dx = torch.zeros_like(x_in._t)
            self._p2p.send(dx, self.rank - 1)
        self._w_stash[i] = (out, g)

    def _w(self, i):
        out, g = self._w_stash.pop(i)
        params = [p for p in self._params if p._t.requires_grad]
        grads = torch.autograd.grad(out._t, [p._t for p in params], g,
                                    allow_unused=True)
        for p, dp in zip(params, grads):
            if dp is None:
                continue
            if p._t.grad is None:
                p._t.grad = dp
            else:
                p._t.grad += dp

    def train_batch(self, micro_inputs=None, micro_labels=None):
        self._check_micros(micro_inputs, micro_labels,
                           self.is_first, self.is_last)
        losses: List[Tensor] = []
        for kind, i in _zero_bubble_schedule(self.rank, self.P, self.m):
            self.executed.append((kind, i))
            self.counts[kind] += 1
            if kind == "F":
                self._f(i, micro_inputs, micro_labels, losses)
            elif kind == "B":
                self._b(i)
            else:
                self._w(i)
            self._track((self._w_stash,))
        total = self._end_batch(losses)
        return total if self.is_last else None


def build_pipeline_runtime(stage_layers, group, loss_fn,
                           num_microbatches, schedule="1F1B"):
    """Schedule-mode dispatch for the host-driven runtimes (the
    pipeline_scheduler_pass role: FThenB / 1F1B / VPP / ZeroBubble by
    strategy.pipeline_configs['schedule_mode']).

    ``stage_layers``: ONE Layer (this rank's stage) for FThenB/1F1B/
    ZeroBubble, or a LIST of chunk Layers for VPP.
    """
    mode = str(schedule)
    if mode not in ("VPP", "Interleave", "interleave") \
            and isinstance(stage_layers, (list, tuple)):
        raise ValueError(
            f"schedule_mode '{schedule}' takes ONE stage Layer per "
            "rank; a chunk list is only valid for VPP")
    if mode in ("FThenB", "F-then-B"):
        return DistPipelineRuntime(stage_layers, group, loss_fn,
                                   num_microbatches, schedule="FThenB")
    if mode == "1F1B":
        return DistPipelineRuntime(stage_layers, group, loss_fn,
                                   num_microbatches, schedule="1F1B")
    if mode in ("VPP", "Interleave", "interleave"):
        if not isinstance(stage_layers, (list, tuple)):
            raise ValueError(
                "VPP needs a list of model-chunk Layers per rank "
                "(virtual stage v = chunk*P + rank)")
        return DistPipelineRuntimeVPP(list(stage_layers), group, loss_fn,
                                      num_microbatches)
    if mode in ("ZeroBubble", "ZBH1", "ZB"):
        return DistPipelineRuntimeZB(stage_layers, group, loss_fn,
                                     num_microbatches)
    raise ValueError(f"unknown pipeline schedule_mode '{schedule}' "
                     "(FThenB | 1F1B | VPP | ZeroBubble)")
