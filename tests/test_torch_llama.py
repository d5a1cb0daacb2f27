"""The port's LLaMA trainer path against the JAX package's, on the CPU.

``llama-tiny`` from the reference's table (4 heads over 2 kv heads, so the
GQA repeat runs), batch 2 × seq 64. Both packages get the same inputs,
made from a seed with numpy; parameters and optimizer state cross over
through numpy (``models/convert.py``). Neither side runs a kernel: the
reference's LLaMA is plain jnp.

Tolerances: fp32 as in ``tests/test_torch_gpt.py`` (2e-5 for activations
and logits, 1e-5 for losses and moments, 1e-4 for gradients), with params
and masters after three steps at 3e-5 (see that test); bf16 ones are
stated where they are used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.models.convert import params_from_numpy, \
    state_from_numpy
from paddle_tpu_torch.models.trainer import tree_leaves, tree_map

BATCH, SEQ = 2, 64


def _configs(dtype="float32", **over):
    ref = dataclasses.replace(ref_llama.LLAMA_CONFIGS["llama-tiny"],
                              dtype=dtype, **over)
    port = dataclasses.replace(pt_llama.LLAMA_CONFIGS["llama-tiny"],
                               dtype=dtype, **over)
    return ref, port


def _batch(seed=0, vocab=1024):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    return tokens, labels


def _ref_params(cfg):
    return jax.device_get(ref_llama.init_llama_params(cfg, seed=0))


def _np(t):
    return t.detach().float().numpy()


def test_config_table_matches_reference():
    assert set(pt_llama.LLAMA_CONFIGS) == set(ref_llama.LLAMA_CONFIGS)
    for name, cfg in ref_llama.LLAMA_CONFIGS.items():
        assert dataclasses.asdict(pt_llama.LLAMA_CONFIGS[name]) == \
            dataclasses.asdict(cfg), name


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype, tie):
    rcfg, pcfg = _configs(dtype, tie_embeddings=tie, num_layers=3)
    ref = _ref_params(rcfg)
    port = pt_llama.init_llama_params(pcfg, seed=0, device="cpu")
    ref_paths = jax.tree_util.tree_flatten_with_path(ref)[0]
    port_paths = jax.tree_util.tree_flatten_with_path(port)[0]
    assert [p for p, _ in ref_paths] == [p for p, _ in port_paths]
    for (path, a), (_, t) in zip(ref_paths, port_paths):
        assert tuple(a.shape) == tuple(t.shape), path
        assert str(t.dtype) == f"torch.{np.dtype(a.dtype).name}", path
        # same distribution, not the same draw: equal stds
        std = float(a.astype(np.float32).std())
        if std > 0:
            assert abs(float(t.float().std()) / std - 1) < 0.2, path
        else:
            assert torch.equal(t, params_from_numpy(a, "cpu")), path
    assert pt_llama.num_params(pcfg) == sum(a.size for _, a in ref_paths)


@pytest.mark.parametrize("tie", [False, True], ids=["untied", "tied"])
def test_weight_decay_mask_matches_reference(monkeypatch, tie):
    """The reference builds its mask inside ``build_train_step``; catch it
    on its way to the trainer."""
    seen = {}

    def capture(loss_fn, init_fn, specs, wd_mask, **kw):
        seen["mask"] = wd_mask
        return None, None

    monkeypatch.setattr(ref_llama, "build_adamw_train_step", capture)
    rcfg, pcfg = _configs(tie_embeddings=tie)
    ref_llama.build_train_step(rcfg)
    assert seen["mask"] == pt_llama.wd_mask(pcfg)


def test_rms_and_rope_match():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 16, 4, 32) * 2 + 0.5).astype(np.float32)
    g = (rng.rand(32) + 0.5).astype(np.float32)
    np.testing.assert_allclose(
        _np(pt_llama._rms(torch.from_numpy(x), torch.from_numpy(g), 1e-6)),
        np.asarray(ref_llama._rms(jnp.asarray(x), jnp.asarray(g), 1e-6)),
        rtol=2e-5, atol=2e-5)
    for theta in (10000.0, 500000.0):
        np.testing.assert_allclose(
            _np(pt_llama._rope(torch.from_numpy(x), theta)),
            np.asarray(ref_llama._rope(jnp.asarray(x), theta)),
            rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_heads", [2, None], ids=["gqa", "mha"])
def test_block_matches(kv_heads):
    rcfg, pcfg = _configs(num_kv_heads=kv_heads)
    params = _ref_params(rcfg)
    blk = {k: v[1] for k, v in params["blocks"].items()}
    x = np.random.RandomState(2).randn(BATCH, SEQ, 128).astype(np.float32)
    ref = ref_llama._block(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, blk), rcfg)
    out = pt_llama._block(torch.from_numpy(x),
                          params_from_numpy(blk, "cpu"), pcfg)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_forward_and_loss_grads_match():
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    tokens, labels = _batch()
    logits_ref = ref_llama.llama_forward(params, jnp.asarray(tokens), rcfg)
    pparams = params_from_numpy(params, "cpu")
    logits = pt_llama.llama_forward(pparams, torch.from_numpy(tokens), pcfg)
    np.testing.assert_allclose(_np(logits), np.asarray(logits_ref),
                               rtol=2e-5, atol=2e-5)

    loss_ref, grads_ref = jax.value_and_grad(ref_llama.llama_loss)(
        params, jnp.asarray(tokens), jnp.asarray(labels), rcfg)
    pparams = tree_map(lambda t: t.requires_grad_(), pparams)
    loss = pt_llama.llama_loss(pparams, torch.from_numpy(tokens),
                               torch.from_numpy(labels), pcfg)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    ref_leaves = jax.tree_util.tree_leaves(grads_ref)
    port_leaves = tree_leaves(pparams)
    assert len(ref_leaves) == len(port_leaves)
    for g_ref, p in zip(ref_leaves, port_leaves):
        np.testing.assert_allclose(_np(p.grad), np.asarray(g_ref),
                                   rtol=1e-4, atol=1e-4)


def test_remat_gives_the_same_loss_and_grads():
    _, pcfg = _configs()
    tokens, labels = (torch.from_numpy(a) for a in _batch(3))
    out = []
    for remat in (False, True):
        params = tree_map(lambda t: t.requires_grad_(),
                          pt_llama.init_llama_params(pcfg, 0, "cpu"))
        loss = pt_llama.llama_loss(params, tokens, labels, pcfg, remat)
        loss.backward()
        out.append((loss.item(), [p.grad for p in tree_leaves(params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bf16_forward_matches_reference():
    """bf16 params: XLA:CPU and PyTorch round to bf16 at other points
    (XLA fuses elementwise chains in fp32 and rounds once), so logits
    differ by a few bf16 ulp: held at 0.02 absolute on logits of magnitude
    up to about 1 (seen: 0.0059, one ulp at 1.0 is 0.0078), and the loss
    at 1e-4 relative (seen: 8.5e-6)."""
    rcfg, pcfg = _configs("bfloat16")
    params = _ref_params(rcfg)
    tokens, labels = _batch(4)
    logits_ref = np.asarray(ref_llama.llama_forward(
        params, jnp.asarray(tokens), rcfg), np.float32)
    pparams = params_from_numpy(params, "cpu")
    logits = pt_llama.llama_forward(pparams, torch.from_numpy(tokens), pcfg)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), logits_ref, rtol=0, atol=0.02)
    loss_ref = float(ref_llama.llama_loss(params, jnp.asarray(tokens),
                                          jnp.asarray(labels), rcfg))
    loss = pt_llama.llama_loss(pparams, torch.from_numpy(tokens),
                               torch.from_numpy(labels), pcfg).item()
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-4)


def _run_both(dtype, steps=3):
    rcfg, pcfg = _configs(dtype)
    init_fn, ref_step = ref_llama.build_train_step(rcfg, mesh=None,
                                                   remat=True)
    state = init_fn(0)
    init_state = jax.device_get(state)
    pstate = state_from_numpy(init_state, "cpu")
    _, port_step = pt_llama.build_train_step(pcfg, remat=True, device="cpu")
    tokens, labels = _batch(1)
    ref_losses, port_losses = [], []
    for _ in range(steps):
        state, loss = ref_step(state, jnp.asarray(tokens), jnp.asarray(labels))
        ref_losses.append(float(loss))
        pstate, ploss = port_step(pstate, torch.from_numpy(tokens),
                                  torch.from_numpy(labels))
        port_losses.append(ploss.item())
    return init_state, jax.device_get(state), pstate, ref_losses, port_losses


def test_three_train_steps_match_fp32():
    """Losses and moments to 1e-5; params and masters to 3e-5: Adam
    divides m by sqrt(v), so where a gradient is near zero its fp32
    summation noise becomes a visible share of a step of about lr = 3e-4
    (seen: 1.15e-5 on one element of 90,112)."""
    _, ref_state, port_state, ref_losses, port_losses = _run_both("float32")
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5)
    assert port_losses[-1] < port_losses[0]
    assert int(ref_state["step"]) == int(port_state["step"]) == 3
    for key, atol in (("params", 3e-5), ("master", 3e-5), ("m", 1e-5),
                      ("v", 1e-5)):
        for a, b in zip(jax.tree_util.tree_leaves(ref_state[key]),
                        tree_leaves(port_state[key])):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=0, atol=atol, err_msg=key)


def test_three_train_steps_match_bf16():
    """bf16 params, held as ``tests/test_torch_gpt.py`` holds the GPT:
    losses to 1e-4 relative; masters to 2e-3 absolute (an Adam step moves
    a weight by about lr = 3e-4 whatever its gradient, so a gradient near
    zero may change sign between the two sides); bf16 params the same plus
    one bf16 ulp; and each leaf's master update (after - initial) to 0.25
    of the reference update's norm, which a master left unchanged fails."""
    init_state, ref_state, port_state, ref_losses, port_losses = \
        _run_both("bfloat16")
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-4)
    assert port_losses[-1] < port_losses[0]
    init = jax.tree_util.tree_leaves(init_state["master"])
    ref_m = jax.tree_util.tree_leaves(ref_state["master"])
    port_m = tree_leaves(port_state["master"])
    for w0, a, b in zip(init, ref_m, port_m):
        upd_ref = np.asarray(a, np.float32) - np.asarray(w0, np.float32)
        upd = _np(b) - np.asarray(w0, np.float32)
        assert np.linalg.norm(upd_ref) > 0
        assert np.linalg.norm(upd - upd_ref) <= 0.25 * np.linalg.norm(upd_ref)
    for key, rtol, atol in (("params", 2 ** -7, 2e-3),
                            ("master", 0, 2e-3)):
        for a, b in zip(jax.tree_util.tree_leaves(ref_state[key]),
                        tree_leaves(port_state[key])):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       rtol=rtol, atol=atol, err_msg=key)


def test_build_train_step_refuses_a_mesh_or_pipeline():
    """A mesh the layout cannot split raises (a pipeline over more stages
    than divide the layers, with the reference's message; kv heads that
    mp does not divide). Without a mesh, pp_microbatches is ignored, as
    in the reference. The mesh trainer itself is held against the
    reference in tests/test_torch_gpt_mesh.py."""
    from paddle_tpu_torch.distributed import ProcessMesh
    _, pcfg = _configs()
    with pytest.raises(ValueError,
                       match="num_layers not divisible by pp degree"):
        pt_llama.build_train_step(
            pcfg, mesh=ProcessMesh(np.arange(3), ["pp"]), device="cpu")
    with pytest.raises(ValueError, match="kv heads 2 not divisible by mp 4"):
        pt_llama.build_train_step(
            pcfg, mesh=ProcessMesh(np.arange(4), ["mp"]), device="cpu")
    pt_llama.build_train_step(pcfg, pp_microbatches=2, device="cpu")


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be "
                    "checked here")
    _, pcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_llama.build_train_step(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_llama.init_llama_params(pcfg)
