"""Entry points: the counterpart of ``__graft_entry__.py``.

``entry()`` returns the forward-only GPT (hidden 512, 4 layers, 8 heads,
vocab 8192, bf16, tokens ``[4, 256]``) as ``(fn, example_args)``.
``dryrun_multichip(n)`` runs ONE full training step of the tiny GPT on an
n-rank ``dp x pp x mp`` mesh (ZeRO-1, the Megatron layout with
sequence parallelism, the pipeline over pp, the flash kernels on each
rank's shard at seq 128), one process per rank: NCCL over the cards, or
gloo on the CPU when ``device="cpu"``.

    python -m paddle_tpu_torch.entry [N]     # N ranks on N cards (default:
                                             # every card of the machine)
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ._core.device import DeviceLike, resolve_device
from .models.gpt import GPTConfig, build_train_step, gpt_forward, \
    init_gpt_params

ENTRY_CONFIG = GPTConfig(vocab_size=8192, hidden_size=512, num_layers=4,
                         num_heads=8, max_position_embeddings=512,
                         dtype="bfloat16")
DRYRUN_CONFIG = GPTConfig(vocab_size=128, hidden_size=64, num_layers=2,
                          num_heads=4, max_position_embeddings=128,
                          dtype="float32")
DRYRUN_SEQ = 128  # the flash path (seq % 128 == 0)


def entry(device: DeviceLike = None):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward
    (logits ``[4, 256, 8192]`` bf16, no remat) of weights from seed 0."""
    dev = resolve_device(device)
    config = ENTRY_CONFIG
    params = init_gpt_params(config, seed=0, device=dev)
    tokens = torch.zeros((4, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        return gpt_forward(params, tokens, config, remat=False)

    return fn, (params, tokens)


def mesh_shape(n: int):
    """n ranks factored into ``(dp, pp, mp)``: peel a 2 for mp, then one
    for pp, the rest is dp (the reference's factoring)."""
    mp = 2 if n % 2 == 0 else 1
    rem = n // mp
    pp = 2 if rem % 2 == 0 else 1
    return rem // pp, pp, mp


def _dryrun_rank(n: int, device: str, params) -> float:
    from .distributed.mesh import ProcessMesh
    dp, pp, mp = mesh_shape(n)
    mesh = ProcessMesh(np.arange(n).reshape(dp, pp, mp), ["dp", "pp", "mp"])
    dev = resolve_device(device if device == "cpu" else None)
    init_fn, step = build_train_step(
        DRYRUN_CONFIG, mesh, lr=1e-3, seq_shard=True, remat=True,
        pp_microbatches=2 if pp > 1 else None, device=dev)
    state = init_fn(0, params=params)
    batch = 4 * dp
    tokens = torch.zeros((batch, DRYRUN_SEQ), dtype=torch.int32, device=dev)
    labels = torch.ones((batch, DRYRUN_SEQ), dtype=torch.int32, device=dev)
    state, loss = step(state, tokens, labels)
    return float(loss)


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     params=None) -> float:
    """One training step of the tiny GPT on an n-rank mesh, one spawned
    process per rank; prints the mesh and the loss and returns the loss.
    ``device`` None: NCCL, rank r on card r (raises when the machine has
    fewer than n cards); ``"cpu"``: gloo. ``params``: the whole starting
    params (numpy arrays, e.g. the reference's), else seed 0's."""
    from .testing.dist import run
    cpu = device is not None and resolve_device(device).type == "cpu"
    if not cpu:
        have = torch.cuda.device_count()
        if n_devices > have:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA devices, found {have}")
    dp, pp, mp = mesh_shape(n_devices)
    losses = run(_dryrun_rank, n_devices, n_devices,
                 "cpu" if cpu else "cuda", params,
                 device="cpu" if cpu else "cuda")
    loss = losses[0]
    if not math.isfinite(loss) or any(x != loss for x in losses):
        raise RuntimeError(f"dryrun losses by rank: {losses}")
    print(f"dryrun_multichip(n={n_devices}) mesh=dp{dp}xpp{pp}xmp{mp} "
          f"loss={loss:.4f} backend={'gloo' if cpu else 'nccl'}")
    return loss


def main(argv) -> int:
    n = int(argv[1]) if len(argv) > 1 else torch.cuda.device_count()
    dryrun_multichip(n)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
