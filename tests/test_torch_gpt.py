"""The port's GPT trainer path against the JAX package's, on the CPU.

Both packages get the same inputs, made from a seed with numpy; parameters
and optimizer state cross over through numpy (``models/convert.py``). The
reference runs its flash-attention kernel in Pallas interpret mode
(``PT_FLASH_INTERPRET=1``) with 128-row blocks at seq 256, so its causal
block skipping runs; the port runs the kernels' plain PyTorch versions,
which is what its wrappers do with CPU tensors.

Tolerances: fp32 throughout, the two sides differ only in summation order
(XLA:CPU against PyTorch's CPU kernels, and the online softmax of the
reference kernel against the plain version's one-pass softmax), so
outputs agree to a few ulp of their magnitude; 2e-5 relative/absolute for
activations, 1e-5 for losses and trainer state as the port's contract
asks, 1e-4 for gradients (sums over the batch and sequence of 512
tokens).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu._core.flags import flag_value, set_flags
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu_torch.models import gpt as pt_gpt
from paddle_tpu_torch.models.convert import params_from_numpy, \
    state_from_numpy
from paddle_tpu_torch.models.trainer import tree_leaves, tree_map

SMALL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             max_position_embeddings=256)
BATCH, SEQ = 2, 256
_BLOCK_FLAGS = ("FLAGS_flash_block_q", "FLAGS_flash_block_k")


def _configs(dtype="float32", **over):
    kw = dict(SMALL, dtype=dtype, **over)
    return ref_gpt.GPTConfig(**kw), pt_gpt.GPTConfig(**kw)


@pytest.fixture
def ref_kernel(monkeypatch):
    """The reference takes its Pallas kernel (interpret mode) with
    128-row blocks, restored afterwards."""
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")
    old = {n: flag_value(n) for n in _BLOCK_FLAGS}
    set_flags({n: 128 for n in _BLOCK_FLAGS})
    yield
    set_flags(old)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, SMALL["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, SMALL["vocab_size"], (BATCH, SEQ)).astype(np.int32)
    return tokens, labels


def _ref_params(cfg):
    return jax.device_get(ref_gpt.init_gpt_params(cfg, seed=0))


def _np(t):
    return t.detach().float().numpy()


def test_ln_matches():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 16, 64).astype(np.float32) * 3 + 1
    g = rng.randn(64).astype(np.float32)
    b = rng.randn(64).astype(np.float32)
    ref = ref_gpt._ln(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5)
    out = pt_gpt._ln(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
def test_block_matches(flash, ref_kernel):
    rcfg, pcfg = _configs(use_flash_attention=flash)
    params = _ref_params(rcfg)
    blk = {k: v[1] for k, v in params["blocks"].items()}
    x = np.random.RandomState(4).randn(BATCH, SEQ, 64).astype(np.float32)
    ref = ref_gpt._block(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, blk), rcfg, None)
    out = pt_gpt._block(torch.from_numpy(x),
                        params_from_numpy(blk, "cpu"), pcfg)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_forward_and_loss_grads_match(ref_kernel):
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    tokens, labels = _batch()
    logits_ref = ref_gpt.gpt_forward(params, jnp.asarray(tokens), rcfg)
    pparams = params_from_numpy(params, "cpu")
    logits = pt_gpt.gpt_forward(pparams, torch.from_numpy(tokens), pcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(logits_ref),
                               rtol=2e-5, atol=2e-5)

    loss_ref, grads_ref = jax.value_and_grad(ref_gpt.gpt_loss)(
        params, jnp.asarray(tokens), jnp.asarray(labels), rcfg)
    pparams = tree_map(lambda t: t.requires_grad_(), pparams)
    loss = pt_gpt.gpt_loss(pparams, torch.from_numpy(tokens),
                           torch.from_numpy(labels), pcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref_leaves = jax.tree_util.tree_leaves(grads_ref)
    port_leaves = tree_leaves(pparams)
    assert len(ref_leaves) == len(port_leaves)
    for g_ref, p in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(_np(p.grad), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-4)


def _run_both(dtype, steps=3):
    rcfg, pcfg = _configs(dtype)
    init_fn, ref_step = ref_gpt.build_train_step(rcfg, mesh=None, remat=True)
    state = init_fn(0)
    init_state = jax.device_get(state)
    pstate = state_from_numpy(init_state, "cpu")
    _, port_step = pt_gpt.build_train_step(pcfg, remat=True, device="cpu")
    tokens, labels = _batch(1)
    ref_losses, port_losses = [], []
    for _ in range(steps):
        state, loss = ref_step(state, jnp.asarray(tokens), jnp.asarray(labels))
        ref_losses.append(float(loss))
        pstate, ploss = port_step(pstate, torch.from_numpy(tokens),
                                  torch.from_numpy(labels))
        port_losses.append(ploss.item())
    return init_state, jax.device_get(state), pstate, ref_losses, port_losses


def _assert_state(ref_state, port_state, atol):
    assert int(ref_state["step"]) == int(port_state["step"])
    for key in ("params", "master", "m", "v"):
        ref_leaves = jax.tree_util.tree_leaves(ref_state[key])
        port_leaves = tree_leaves(port_state[key])
        for a, b in zip(ref_leaves, port_leaves):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=0, atol=atol, err_msg=key)


def _named_leaves(tree, prefix=""):
    """``{path: fp32 numpy}`` for a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        return {name: leaf for k in sorted(tree)
                for name, leaf in _named_leaves(tree[k], f"{prefix}{k}/")
                .items()}
    leaf = _np(tree) if torch.is_tensor(tree) else np.asarray(tree, np.float32)
    return {prefix[:-1]: leaf}


def _master_updates(init_state, state):
    """``master - initial master`` per leaf, without the key third of
    ``qkv_b`` (see ``test_three_train_steps_match_bf16``)."""
    h = SMALL["hidden_size"]
    init = _named_leaves(init_state["master"])
    upd = {name: w - init[name]
           for name, w in _named_leaves(state["master"]).items()}
    qkv_b = upd["blocks/qkv_b"]
    upd["blocks/qkv_b"] = np.concatenate([qkv_b[..., :h],
                                          qkv_b[..., 2 * h:]], -1)
    return upd


def test_three_train_steps_match_fp32(ref_kernel):
    _, ref_state, port_state, ref_losses, port_losses = _run_both("float32")
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5)
    assert port_losses[-1] < port_losses[0]
    _assert_state(ref_state, port_state, atol=1e-5)


def test_three_train_steps_match_bf16(ref_kernel):
    """bf16 params: XLA:CPU and PyTorch round to bf16 at other points
    (XLA fuses elementwise chains in fp32 and rounds once; PyTorch rounds
    after every op), so activations and gradients differ by a few bf16
    ulp (2^-8 relative each). Held at:

    - losses, 1e-4 relative (seen: 7e-6);
    - master weights, 2e-3 absolute: an Adam step moves a weight by about
      lr = 3e-4 whatever the gradient's size, so where a gradient is near
      zero its sign can differ between the two sides, at most 2*3*3e-4
      over three steps (seen: 1.2e-3);
    - bf16 params, the same plus one bf16 ulp (2^-7 relative), as two
      masters that differ can round to neighbouring bf16 values;
    - the moments, 0.1 of each leaf's largest magnitude: they are sums of
      raw bf16 gradients and carry their differences directly (seen: up
      to 0.039);
    - the master update itself (after - initial), per leaf, to 0.25 of the
      reference update's norm (seen: up to 0.113, final LayerNorm gain;
      the big matrices 0.03-0.04). The absolute limits above are wider
      than three steps' movement, so this is the check that a master left
      unchanged (which reads 1.0) fails. The key third of ``qkv_b`` is
      left out: its exact gradient is zero (a key bias adds the same
      q.b to every logit of a row, which softmax ignores), so its update
      is rounding noise on both sides (seen: 1.16).
    """
    init_state, ref_state, port_state, ref_losses, port_losses = \
        _run_both("bfloat16")
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-4)
    assert port_losses[-1] < port_losses[0]
    assert int(ref_state["step"]) == int(port_state["step"]) == 3
    ref_upd = _master_updates(init_state, ref_state)
    port_upd = _master_updates(init_state, port_state)
    assert ref_upd.keys() == port_upd.keys()
    for name, upd in ref_upd.items():
        assert np.linalg.norm(upd) > 0, name
        rel = np.linalg.norm(port_upd[name] - upd) / np.linalg.norm(upd)
        assert rel <= 0.25, (name, rel)
    for key, rtol, atol in (("params", 2 ** -7, 2e-3),
                            ("master", 0, 2e-3)):
        for a, b in zip(jax.tree_util.tree_leaves(ref_state[key]),
                        tree_leaves(port_state[key])):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=rtol, atol=atol, err_msg=key)
    for key in ("m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(ref_state[key]),
                        tree_leaves(port_state[key])):
            a = np.asarray(a, np.float32)
            np.testing.assert_allclose(_np(b), a, rtol=0,
                                       atol=0.1 * np.abs(a).max(),
                                       err_msg=key)
