"""The port's mesh trainers against the JAX package's, on the CPU.

The port runs on gloo ranks (``paddle_tpu_torch.testing.dist``, one
world of eight spawned processes for the module; a mesh of four uses its
first four ranks); the reference runs the same ``build_train_step`` on
the same mesh shape of its eight virtual CPU devices. Both start from the
reference's params (seed 0, crossed as numpy), take the same three
batches from a numpy seed, and are held after each step (the loss) and
after the last (params and optimizer state, gathered from the ranks'
shards; replicas of a block must agree bit for bit).

- GPT at ``__graft_entry__.dryrun_multichip``'s config (vocab 128, hidden
  64, 2 layers, 4 heads, fp32, seq 128: the flash path on both sides, the
  reference's Pallas kernels in interpret mode) on dp2 x pp2 x mp2 with
  ``seq_shard``, ZeRO-1, remat and 2 micro-batches, and on dp8; on dp2 x
  pp2 at the config of the reference's own mesh-against-single test
  (``tests/test_pipeline_compiled.py``: seq 16, the dense path, 4
  micro-batches, no remat).
- LLaMA (llama-tiny, grouped-query: 4 heads, 2 kv heads) on dp2 x mp2
  and pp2; BERT (bert-tiny, 2 heads) on dp2 x mp2, a third of its labels
  -100.
- ``entry()``'s bf16 logits against the reference's ``entry()``, and
  ``dryrun_multichip(8, device="cpu")`` against the reference's dryrun
  step from the same weights.

Tolerances: losses at 1e-5 relative, params and optimizer state after
three steps at 1e-4 relative / 1e-5 absolute (the reference's own
mesh-against-single limits): fp32 on both sides, the sums over ranks
and micro-batches in other orders. LLaMA's params and masters are held at
3e-5 absolute, as ``tests/test_torch_llama.py`` holds its single-device
steps and for the reason it gives: Adam divides m by sqrt(v), so where a
gradient is near zero its fp32 summation noise becomes a visible share of
a step of about lr (one element of `down_w`'s 90,112 moved 1.2e-5 and
1.7e-5 from the reference's on the two meshes).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_ranks as ranks
from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.models import llama as ref_llama
from paddle_tpu_torch import entry as pt_entry
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import bert as pt_bert
from paddle_tpu_torch.models import gpt as pt_gpt
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.models.convert import gather_shards, params_from_numpy
from paddle_tpu_torch.models.trainer import state_specs, tree_leaves, \
    tree_map
from paddle_tpu_torch.testing.dist import World

DRY = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4,
           max_position_embeddings=128, dtype="float32")
SMALL_PP = dict(vocab_size=64, hidden_size=32, num_layers=4, num_heads=4,
                max_position_embeddings=32, dtype="float32")
# the reference's llama-tiny and bert-tiny, in fp32
LLAMA = dict(dataclasses.asdict(ref_llama.LLAMA_CONFIGS["llama-tiny"]),
             dtype="float32")
BERT = dict(dataclasses.asdict(ref_bert.BERT_CONFIGS["bert-tiny"]),
            dtype="float32")
STEPS = 3
# the absolute limit of params and masters, by case (default 1e-5)
STATE_ATOL = {"llama-dp2xmp2": 3e-5, "llama-pp2": 3e-5}

# name: (model, config, mesh shape, axis names, build kwargs, batch, seq)
CASES = {
    "gpt-dp2xpp2xmp2": ("gpt", DRY, (2, 2, 2), ("dp", "pp", "mp"),
                        dict(lr=1e-3, seq_shard=True, zero1=True,
                             remat=True, pp_microbatches=2), 8, 128),
    "gpt-dp2xpp2": ("gpt", SMALL_PP, (2, 2), ("dp", "pp"),
                    dict(lr=1e-3, remat=False, pp_microbatches=4), 8, 16),
    "gpt-dp8": ("gpt", DRY, (8,), ("dp",), dict(lr=1e-3), 8, 128),
    "llama-dp2xmp2": ("llama", LLAMA, (2, 2), ("dp", "mp"), dict(lr=1e-3),
                      4, 32),
    "llama-pp2": ("llama", LLAMA, (2,), ("pp",),
                  dict(lr=1e-3, pp_microbatches=2), 4, 32),
    "bert-dp2xmp2": ("bert", BERT, (2, 2), ("dp", "mp"), dict(lr=1e-3),
                     4, 32),
}
REF = {"gpt": (ref_gpt, ref_gpt.GPTConfig, ref_gpt.init_gpt_params),
       "llama": (ref_llama, ref_llama.LlamaConfig,
                 ref_llama.init_llama_params),
       "bert": (ref_bert, ref_bert.BertConfig, ref_bert.init_bert_params)}
PORT = {"gpt": (pt_gpt, pt_gpt.GPTConfig),
        "llama": (pt_llama, pt_llama.LlamaConfig),
        "bert": (pt_bert, pt_bert.BertConfig)}


@pytest.fixture(scope="module")
def world():
    with World(8) as w:
        yield w


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    """The reference takes its flash kernel (Pallas interpret mode) where
    its config and sequence ask for it, as the port always does."""
    monkeypatch.setenv("PT_FLASH_INTERPRET", "1")


def _batches(model, vocab, batch, seq):
    r = np.random.RandomState(7)
    out = []
    for _ in range(STEPS):
        tokens = r.randint(0, vocab, (batch, seq)).astype(np.int32)
        labels = r.randint(0, vocab, (batch, seq)).astype(np.int32)
        if model == "bert":
            labels[r.rand(batch, seq) < 1 / 3] = -100
        out.append((tokens, labels))
    return out


def _reference(model, config, shape, names, build, batches):
    module, cfg_cls, init = REF[model]
    n = int(np.prod(shape))
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)
    cfg = cfg_cls(**config)
    params = jax.device_get(init(cfg, 0))
    init_fn, step = module.build_train_step(cfg, mesh, **build)
    state = init_fn(0)
    losses = []
    for tokens, labels in batches:
        state, loss = step(state, jnp.asarray(tokens), jnp.asarray(labels))
        losses.append(float(loss))
    final = {k: jax.tree_util.tree_map(lambda a: np.array(a), state[k])
             for k in ("params", "master", "m", "v")}
    return params, losses, final


def _specs(model, config, shape, names, params):
    module, cfg_cls = PORT[model]
    cfg = cfg_cls(**config)
    mesh = ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       list(names))
    if model == "bert":
        specs = module.param_specs(cfg)
    else:
        specs = module.param_specs(
            cfg, pp="pp" if "pp" in names else None)
    shapes = tree_map(lambda a: a.shape, params)
    groups = getattr(module, "SPLIT_GROUPS", None)
    return mesh, state_specs(specs, shapes, mesh), groups


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                         f"{prefix}/{k}")]
    return [prefix]


@pytest.mark.parametrize("name", list(CASES))
def test_three_steps_match_reference(world, name):
    model, config, shape, names, build, batch, seq = CASES[name]
    batches = _batches(model, config["vocab_size"], batch, seq)
    params, want_losses, want = _reference(model, config, shape, names,
                                           build, batches)
    port = world.run(ranks.train, model, config, shape, names, build,
                     params, batches)
    n = int(np.prod(shape))
    assert all(p is None for p in port[n:])
    for r in range(n):  # every rank returns the global loss
        np.testing.assert_allclose(port[r][0], want_losses, rtol=1e-5,
                                   err_msg=f"losses of rank {r}")
    mesh, (p_specs, o_specs), groups = _specs(model, config, shape, names,
                                              params)
    for key in ("params", "master", "m", "v"):
        got = gather_shards([port[r][1][key] for r in range(n)],
                            p_specs if key == "params" else o_specs, mesh,
                            groups)
        atol = STATE_ATOL.get(name, 1e-5) \
            if key in ("params", "master") else 1e-5
        for path, a, b in zip(_paths(got), tree_leaves(got),
                              tree_leaves(want[key])):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=atol,
                                       err_msg=f"{key}{path}")


@pytest.mark.parametrize("shape,names", [((2,), ("pp",)),
                                         ((2, 2), ("pp", "mp"))])
def test_pipeline_blocks_take_the_flash_kernels(world, shape, names):
    """Inside the pipeline the blocks call the flash entry on every mesh
    whose sequence tiles by 128, also where the reference's nested
    shard_map falls back to its dense path (no dp, or heads mp does not
    divide): the port's shard-local call has no such limit. One step of
    the dryrun config, 2 micro-batches, no remat: each rank's one layer
    runs once a micro-batch."""
    got = world.run(ranks.pipeline_attention_route, DRY, shape, names, 4,
                    128)
    n = int(np.prod(shape))
    for r in range(n):
        loss, calls = got[r]
        assert np.isfinite(loss)
        assert calls == DRY["num_layers"] // shape[0] * 2, (r, calls)


def test_entry_logits_match_reference():
    """bf16 forward of the same weights; both sides take the flash path
    (the reference in interpret mode). Every logit within 2 ulp of bf16 at
    the largest logit's magnitude (2^-6 at |logit| 2.06; 1.5 ulp seen):
    each layer rounds its activations to bf16 after products that
    accumulate in another order, and a logit that is a small sum of
    large terms keeps the error of their scale."""
    import __graft_entry__ as ref_entry
    ref_fn, (ref_params, ref_tokens) = ref_entry.entry()
    want = np.asarray(jax.jit(ref_fn)(ref_params, ref_tokens),
                      np.float32)
    fn, (params, tokens) = pt_entry.entry(device="cpu")
    assert tuple(tokens.shape) == tuple(ref_tokens.shape)
    crossed = params_from_numpy(jax.device_get(ref_params), "cpu")
    for a, b in zip(tree_leaves(crossed), tree_leaves(params)):
        assert a.shape == b.shape and a.dtype == b.dtype
    got = fn(crossed, tokens).float().numpy()
    assert got.shape == (4, 256, 8192)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    err = float(np.abs(got - want).max())
    assert err <= 2 * ulp, (err, ulp)


def test_dryrun_multichip_matches_reference(capfd):
    """``dryrun_multichip(8, device="cpu")`` on the reference's weights
    gives the reference's dryrun loss (its step on dp2 x pp2 x mp2, zero
    tokens, labels 1)."""
    cfg = ref_gpt.GPTConfig(**DRY)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "pp", "mp"))
    init_fn, step = ref_gpt.build_train_step(
        cfg, mesh, lr=1e-3, seq_shard=True, remat=True, pp_microbatches=2)
    state = init_fn(0)
    params = jax.device_get(state["params"])
    params = jax.tree_util.tree_map(np.array, params)
    _, want = step(state, jnp.zeros((8, 128), jnp.int32),
                   jnp.ones((8, 128), jnp.int32))
    got = pt_entry.dryrun_multichip(8, device="cpu", params=params)
    assert "mesh=dp2xpp2xmp2" in capfd.readouterr().out
    assert abs(got - float(want)) <= 1e-5 * abs(float(want))


def test_dryrun_multichip_without_cards_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card rule cannot be "
                    "checked here")
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        pt_entry.dryrun_multichip(2)
