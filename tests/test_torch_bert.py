"""The port's BERT/ERNIE trainer path against the JAX package's, on the
CPU.

``bert-tiny`` from the reference's table (2 layers, hidden 128, 2 heads),
batch 2 x seq 64. Both packages get the same inputs, made from a seed with
numpy; parameters and optimizer state cross over through numpy
(``models/convert.py``). Neither side runs a kernel: the reference's BERT
is plain jnp (dense attention).

Tolerances: fp32 at 1e-5 absolute and relative throughout (activations,
logits, losses, every gradient, and params, masters and moments after
three AdamW steps at the reference's lr of 1e-4); bf16 ones are stated
where they are used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import bert as ref_bert
from paddle_tpu_torch.models import bert as pt_bert
from paddle_tpu_torch.models.convert import params_from_numpy, \
    state_from_numpy
from paddle_tpu_torch.models.trainer import tree_leaves, tree_map

BATCH, SEQ = 2, 64
TOL = dict(rtol=1e-5, atol=1e-5)


def _configs(dtype="float32", **over):
    ref = dataclasses.replace(ref_bert.BERT_CONFIGS["bert-tiny"],
                              dtype=dtype, **over)
    port = dataclasses.replace(pt_bert.BERT_CONFIGS["bert-tiny"],
                               dtype=dtype, **over)
    return ref, port


def _batch(seed=0, vocab=1024, ignore=0.0):
    """tokens and labels; a share ``ignore`` of the labels set to -100."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels = rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32)
    labels[rng.uniform(0, 1, labels.shape) < ignore] = -100
    return tokens, labels


def _masks(seed=0):
    """token types (0/1) and a padding mask that drops the last 16 keys of
    the second row."""
    rng = np.random.RandomState(seed)
    types = rng.randint(0, 2, (BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.int32)
    mask[1, -16:] = 0
    return types, mask


def _ref_params(cfg):
    return jax.device_get(ref_bert.init_bert_params(cfg, seed=0))


def _np(t):
    return t.detach().float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_table_matches_reference():
    assert set(pt_bert.BERT_CONFIGS) == set(ref_bert.BERT_CONFIGS)
    for name, cfg in ref_bert.BERT_CONFIGS.items():
        port = pt_bert.BERT_CONFIGS[name]
        assert dataclasses.asdict(port) == dataclasses.asdict(cfg), name
        assert port.head_dim == cfg.head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_param_tree_matches_reference(dtype):
    rcfg, pcfg = _configs(dtype, num_layers=3)
    ref = _ref_params(rcfg)
    port = pt_bert.init_bert_params(pcfg, seed=0, device="cpu")
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


def test_weight_decay_mask_matches_reference(monkeypatch):
    """The reference builds its mask inside ``build_train_step``; catch it
    on its way to the trainer."""
    seen = {}

    def capture(loss_fn, init_fn, specs, wd_mask, **kw):
        seen["mask"], seen["kw"] = wd_mask, kw
        return None, None

    monkeypatch.setattr(ref_bert, "build_adamw_train_step", capture)
    rcfg, pcfg = _configs()
    ref_bert.build_train_step(rcfg)
    assert seen["mask"] == pt_bert.wd_mask(pcfg)
    assert seen["kw"]["lr"] == 1e-4


def test_layer_norm_matches():
    rng = np.random.RandomState(1)
    x = (rng.randn(2, 16, 128) * 3 + 0.5).astype(np.float32)
    g = (rng.rand(128) + 0.5).astype(np.float32)
    b = rng.randn(128).astype(np.float32)
    np.testing.assert_allclose(
        _np(pt_bert._ln(_t(x), _t(g), _t(b), 1e-12)),
        np.asarray(ref_bert._ln(jnp.asarray(x), jnp.asarray(g),
                                jnp.asarray(b), 1e-12)), **TOL)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_block_matches(masked):
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    blk = {k: v[1] for k, v in params["blocks"].items()}
    x = np.random.RandomState(2).randn(BATCH, SEQ, 128).astype(np.float32)
    mask = None
    if masked:
        m = _masks()[1]
        mask = (1.0 - m[:, None, None, :].astype(np.float32)) * -1e30
    ref = ref_bert._block(jnp.asarray(x), jax.tree_util.tree_map(
        jnp.asarray, blk), rcfg,
        None if mask is None else jnp.asarray(mask))
    out = pt_bert._block(_t(x), params_from_numpy(blk, "cpu"), pcfg,
                         None if mask is None else _t(mask))
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


@pytest.mark.parametrize("types", [False, True], ids=["notypes", "types"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_encode_matches(masked, types):
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    tokens, _ = _batch()
    tt, m = _masks()
    tt = tt if types else None
    m = m if masked else None
    ref = ref_bert.bert_encode(
        params, jnp.asarray(tokens), None if tt is None else jnp.asarray(tt),
        None if m is None else jnp.asarray(m), rcfg)
    out = pt_bert.bert_encode(
        params_from_numpy(params, "cpu"), _t(tokens).long(),
        None if tt is None else _t(tt).long(),
        None if m is None else _t(m), pcfg)
    np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)


def _loss_and_grads(rcfg, pcfg, params, tokens, labels):
    loss_ref, grads_ref = jax.value_and_grad(ref_bert.bert_mlm_loss)(
        params, jnp.asarray(tokens), jnp.asarray(labels), rcfg)
    pparams = tree_map(lambda t: t.requires_grad_(),
                       params_from_numpy(params, "cpu"))
    loss = pt_bert.bert_mlm_loss(pparams, _t(tokens).long(),
                                 _t(labels).long(), pcfg)
    loss.backward()
    return (float(loss_ref), jax.tree_util.tree_leaves(grads_ref),
            loss.item(), [p.grad for p in tree_leaves(pparams)])


def test_logits_loss_and_every_grad_match():
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    tokens, labels = _batch(ignore=0.85)  # MLM: most positions unscored
    _, m = _masks()
    for mask in (None, m):
        logits_ref = ref_bert.bert_mlm_logits(
            params, jnp.asarray(tokens), rcfg,
            attention_mask=None if mask is None else jnp.asarray(mask))
        logits = pt_bert.bert_mlm_logits(
            params_from_numpy(params, "cpu"), _t(tokens).long(), pcfg,
            attention_mask=None if mask is None else _t(mask))
        np.testing.assert_allclose(_np(logits), np.asarray(logits_ref),
                                   **TOL)
    loss_ref, grads_ref, loss, grads = _loss_and_grads(
        rcfg, pcfg, params, tokens, labels)
    np.testing.assert_allclose(loss, loss_ref, rtol=1e-5)
    assert len(grads_ref) == len(grads)
    for g_ref, g in zip(grads_ref, grads):
        np.testing.assert_allclose(_np(g), np.asarray(g_ref), **TOL)


def test_a_batch_with_every_label_ignored():
    """The loss divides by max(count, 1): 0, and every gradient 0, on
    both sides."""
    rcfg, pcfg = _configs()
    params = _ref_params(rcfg)
    tokens, labels = _batch(ignore=1.0)
    assert (labels < 0).all()
    loss_ref, grads_ref, loss, grads = _loss_and_grads(
        rcfg, pcfg, params, tokens, labels)
    assert loss == loss_ref == 0.0
    for g_ref, g in zip(grads_ref, grads):
        assert not np.asarray(g_ref).any()
        assert not g.any()


def test_remat_gives_the_same_loss_and_grads():
    _, pcfg = _configs()
    tokens, labels = (_t(a).long() for a in _batch(3, ignore=0.5))
    out = []
    for remat in (False, True):
        params = tree_map(lambda t: t.requires_grad_(),
                          pt_bert.init_bert_params(pcfg, 0, "cpu"))
        loss = pt_bert.bert_mlm_loss(params, tokens, labels, pcfg, remat)
        loss.backward()
        out.append((loss.item(), [p.grad for p in tree_leaves(params)]))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_bf16_forward_matches_reference(masked):
    """bf16 params, through both of the reference's routes: without a mask
    the logits stay bf16 into the softmax, with one the fp32 mask promotes
    them. XLA:CPU and PyTorch round to bf16 at other points (XLA fuses
    elementwise chains in fp32 and rounds once), so the MLM logits are held
    at 0.02 absolute, as ``tests/test_torch_llama.py`` holds its logits,
    and the loss at 1e-4 relative."""
    rcfg, pcfg = _configs("bfloat16")
    params = _ref_params(rcfg)
    tokens, labels = _batch(4, ignore=0.5)
    mask = _masks()[1] if masked else None
    logits_ref = np.asarray(ref_bert.bert_mlm_logits(
        params, jnp.asarray(tokens), rcfg,
        attention_mask=None if mask is None else jnp.asarray(mask)),
        np.float32)
    pparams = params_from_numpy(params, "cpu")
    logits = pt_bert.bert_mlm_logits(
        pparams, _t(tokens).long(), pcfg,
        attention_mask=None if mask is None else _t(mask))
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(logits), logits_ref, rtol=0, atol=0.02)
    if not masked:  # the loss takes no mask, in both packages
        loss_ref = float(ref_bert.bert_mlm_loss(
            params, jnp.asarray(tokens), jnp.asarray(labels), rcfg))
        loss = pt_bert.bert_mlm_loss(pparams, _t(tokens).long(),
                                     _t(labels).long(), pcfg).item()
        np.testing.assert_allclose(loss, loss_ref, rtol=1e-4)


def _run_both(steps=3):
    rcfg, pcfg = _configs()
    init_fn, ref_step = ref_bert.build_train_step(rcfg, mesh=None,
                                                  remat=True)
    state = init_fn(0)
    init_state = jax.device_get(state)
    pstate = state_from_numpy(init_state, "cpu")
    _, port_step = pt_bert.build_train_step(pcfg, remat=True, device="cpu")
    tokens, labels = _batch(1, ignore=0.85)
    ref_losses, port_losses = [], []
    for _ in range(steps):
        state, loss = ref_step(state, jnp.asarray(tokens), jnp.asarray(labels))
        ref_losses.append(float(loss))
        pstate, ploss = port_step(pstate, _t(tokens).long(),
                                  _t(labels).long())
        port_losses.append(ploss.item())
    return jax.device_get(state), pstate, ref_losses, port_losses


def test_three_train_steps_match_fp32():
    ref_state, port_state, ref_losses, port_losses = _run_both()
    np.testing.assert_allclose(port_losses, ref_losses, rtol=1e-5)
    assert port_losses[-1] < port_losses[0]
    assert int(ref_state["step"]) == int(port_state["step"]) == 3
    for key in ("params", "master", "m", "v"):
        ref_leaves = jax.tree_util.tree_leaves(ref_state[key])
        port_leaves = tree_leaves(port_state[key])
        assert len(ref_leaves) == len(port_leaves)
        for a, b in zip(ref_leaves, port_leaves):
            np.testing.assert_allclose(_np(b), np.asarray(a, np.float32),
                                       err_msg=key, **TOL)


def test_build_train_step_refuses_a_mesh():
    """A mesh whose mp does not divide the heads raises: the shard-local
    layout splits them. The mesh trainer itself is held against the
    reference in tests/test_torch_gpt_mesh.py."""
    from paddle_tpu_torch.distributed import ProcessMesh
    _, pcfg = _configs()
    with pytest.raises(ValueError, match="num_heads 2 not divisible by mp 4"):
        pt_bert.build_train_step(
            pcfg, mesh=ProcessMesh(np.arange(4), ["mp"]), device="cpu")


def test_entry_points_raise_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be "
                    "checked here")
    _, pcfg = _configs()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_bert.build_train_step(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_bert.init_bert_params(pcfg)
