"""The port's mesh layout against the JAX package's, on the CPU, in one
process (no ranks are started).

- ``param_specs`` of GPT, LLaMA and BERT, and ``filter_specs_for_mesh`` /
  ``zero1_opt_specs`` of the trainer, equal the reference's entry by entry
  on (dp2, pp2, mp2), (dp2, mp4), (dp8,) and (pp4,), with and without the
  pp split of the blocks.
- A ``ProcessMesh`` over ``arange(n)`` puts rank r where the reference's
  ``np.reshape(devices, shape)`` puts device r.
- ``convert.shard_for_rank`` gives each rank the block the reference's
  sharding puts on its device (the fused qkv leaves excepted: the port
  splits them by heads, :data:`models.gpt.SPLIT_GROUPS`), and
  ``gather_shards`` puts the blocks back together, exactly.
"""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding

from paddle_tpu.models import bert as ref_bert
from paddle_tpu.models import gpt as ref_gpt
from paddle_tpu.models import llama as ref_llama
from paddle_tpu.models import trainer as ref_trainer
from paddle_tpu_torch.distributed.mesh import PartitionSpec as P
from paddle_tpu_torch.distributed.mesh import ProcessMesh
from paddle_tpu_torch.models import bert as pt_bert
from paddle_tpu_torch.models import gpt as pt_gpt
from paddle_tpu_torch.models import llama as pt_llama
from paddle_tpu_torch.models import trainer as pt_trainer
from paddle_tpu_torch.models.convert import gather_shards, shard_for_rank

MESHES = [((2, 2, 2), ("dp", "pp", "mp")), ((2, 4), ("dp", "mp")),
          ((8,), ("dp",)), ((4,), ("pp",))]
GPT_KW = dict(vocab_size=128, hidden_size=64, num_layers=4, num_heads=4,
              max_position_embeddings=128, dtype="float32")
LLAMA_KW = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=4, num_heads=4, num_kv_heads=2,
                max_position_embeddings=64, dtype="float32")
BERT_KW = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
               intermediate_size=128, max_position_embeddings=64,
               dtype="float32")


def _ref_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _pt_mesh(shape, names):
    return ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                       list(names))


def _flat(tree):
    """(path, spec as a tuple) pairs in sorted-key order."""
    if isinstance(tree, dict):
        return [(f"{k}/{p}" if p else k, s) for k in sorted(tree)
                for p, s in _flat(tree[k])]
    return [("", tuple(tree))]


def _cases():
    """(name, reference specs, port specs, whole param tree) per model and
    pp setting."""
    out = []
    for pp in (None, "pp"):
        out.append((f"gpt-{pp}", ref_gpt.param_specs(
            ref_gpt.GPTConfig(**GPT_KW), pp=pp), pt_gpt.param_specs(
            pt_gpt.GPTConfig(**GPT_KW), pp=pp),
            jax.device_get(ref_gpt.init_gpt_params(
                ref_gpt.GPTConfig(**GPT_KW), 0))))
        for tie in (False, True):
            rc = ref_llama.LlamaConfig(tie_embeddings=tie, **LLAMA_KW)
            out.append((f"llama-{pp}-tie{tie}", ref_llama.param_specs(
                rc, pp=pp), pt_llama.param_specs(
                pt_llama.LlamaConfig(tie_embeddings=tie, **LLAMA_KW),
                pp=pp), jax.device_get(ref_llama.init_llama_params(rc, 0))))
    rc = ref_bert.BertConfig(**BERT_KW)
    out.append(("bert", ref_bert.param_specs(rc), pt_bert.param_specs(
        pt_bert.BertConfig(**BERT_KW)),
        jax.device_get(ref_bert.init_bert_params(rc, 0))))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_param_specs_match(case):
    _, ref_specs, pt_specs, _ = case
    assert _flat(pt_specs) == _flat(ref_specs)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{n}{s}" for n, s in zip(m[1], m[0])))
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_filter_and_zero1_specs_match(case, mesh):
    _, ref_specs, pt_specs, params = case
    shape, names = mesh
    rm, pm = _ref_mesh(shape, names), _pt_mesh(shape, names)
    ref_f = ref_trainer.filter_specs_for_mesh(ref_specs, rm)
    pt_f = pt_trainer.filter_specs_for_mesh(pt_specs, pm)
    assert _flat(pt_f) == _flat(ref_f)
    shapes = jax.tree_util.tree_map(lambda a: a.shape, params)
    ref_z = ref_trainer.zero1_opt_specs(
        ref_f, jax.eval_shape(lambda: params), rm)
    pt_z = pt_trainer.zero1_opt_specs(pt_f, shapes, pm)
    assert _flat(pt_z) == _flat(ref_z)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{n}{s}" for n, s in zip(m[1], m[0])))
def test_rank_coordinates_match_device_order(mesh):
    shape, names = mesh
    rm, pm = _ref_mesh(shape, names), _pt_mesh(shape, names)
    for coord in np.ndindex(*shape):
        rank = int(pm.mesh[coord])
        assert rm.devices[coord].id == rank
        assert pm.coords(rank) == dict(zip(names, coord))
        for axis in names:
            i = names.index(axis)
            line = [int(d.id) for d in np.moveaxis(rm.devices, i, 0)[
                (slice(None),) + tuple(c for j, c in enumerate(coord)
                                       if j != i)]]
            assert pm.line(axis, rank) == line


@pytest.mark.parametrize("mesh", MESHES[:2], ids=["dp2xpp2xmp2", "dp2xmp4"])
def test_shards_match_reference_device_blocks(mesh):
    """Each rank's block of every GPT leaf (params and ZeRO-1 state) is the
    block the reference's NamedSharding puts on that rank's device; the
    qkv leaves take their heads' columns of q, k and v instead."""
    shape, names = mesh
    rm, pm = _ref_mesh(shape, names), _pt_mesh(shape, names)
    cfg = pt_gpt.GPTConfig(**GPT_KW)
    params = jax.device_get(ref_gpt.init_gpt_params(
        ref_gpt.GPTConfig(**GPT_KW), 0))
    shapes = jax.tree_util.tree_map(lambda a: a.shape, params)
    pp = "pp" if "pp" in names else None
    p_specs, o_specs = pt_trainer.state_specs(
        pt_gpt.param_specs(cfg, pp=pp), shapes, pm)
    ref_p = ref_trainer.filter_specs_for_mesh(
        ref_gpt.param_specs(ref_gpt.GPTConfig(**GPT_KW), pp=pp), rm)
    ref_o = ref_trainer.zero1_opt_specs(
        ref_p, jax.eval_shape(lambda: params), rm)
    for specs, ref_specs in ((p_specs, ref_p), (o_specs, ref_o)):
        placed = jax.device_put(params, jax.tree_util.tree_map(
            lambda sp: NamedSharding(rm, sp), ref_specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        for rank in range(pm.size):
            mine = shard_for_rank(params, specs, pm, rank,
                                  pt_gpt.SPLIT_GROUPS)
            for (path, got), leaf in zip(
                    jax.tree_util.tree_flatten_with_path(mine)[0],
                    jax.tree_util.tree_leaves(placed)):
                want = next(np.asarray(s.data) for s in
                            leaf.addressable_shards if s.device.id == rank)
                assert got.shape == want.shape, path
                if "qkv" not in jax.tree_util.keystr(path) \
                        or pm.axis_size("mp") == 1:
                    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    f"{n}{s}" for n, s in zip(m[1], m[0])))
def test_shard_gather_round_trip(mesh):
    shape, names = mesh
    pm = _pt_mesh(shape, names)
    cfg = pt_gpt.GPTConfig(**GPT_KW)
    params = pt_trainer.tree_map(
        lambda t: t.numpy(), pt_gpt.init_gpt_params(cfg, 3, device="cpu"))
    shapes = pt_trainer.tree_map(lambda a: a.shape, params)
    pp = "pp" if "pp" in names else None
    for specs in pt_trainer.state_specs(pt_gpt.param_specs(cfg, pp=pp),
                                        shapes, pm):
        shards = [shard_for_rank(params, specs, pm, r, pt_gpt.SPLIT_GROUPS)
                  for r in range(pm.size)]
        back = gather_shards(shards, specs, pm, pt_gpt.SPLIT_GROUPS)
        for a, b in zip(pt_trainer.tree_leaves(back),
                        pt_trainer.tree_leaves(params)):
            np.testing.assert_array_equal(a, b)


def test_qkv_shard_holds_its_heads():
    """On mp 2, rank r's qkv columns are q, k and v of heads [2r, 2r+2)."""
    pm = _pt_mesh((2,), ("mp",))
    h, hd = 64, 16
    w = np.arange(h * 3 * h, dtype=np.float32).reshape(h, 3 * h)
    for r in range(2):
        got = shard_for_rank({"blocks": {"qkv_w": w}},
                             {"blocks": {"qkv_w": P(None, "mp")}}, pm, r,
                             pt_gpt.SPLIT_GROUPS)["blocks"]["qkv_w"]
        want = w.reshape(h, 3, 4, hd)[:, :, 2 * r:2 * r + 2].reshape(h, -1)
        np.testing.assert_array_equal(got, want)


def test_gather_refuses_replicas_that_differ():
    pm = _pt_mesh((2,), ("dp",))
    shards = [{"a": np.zeros(4, np.float32)}, {"a": np.ones(4, np.float32)}]
    with pytest.raises(ValueError, match="replicas"):
        gather_shards(shards, {"a": P(None)}, pm)


def test_indivisible_dims_stay_whole():
    """A dim the axis does not divide is not split (the reference's GSPMD
    pads it): wte of a vocabulary of 100 on mp 8."""
    pm = _pt_mesh((8,), ("mp",))
    specs = {"wte": P("mp", None), "b": P("mp")}
    got = pt_trainer.fit_specs(specs, {"wte": (100, 64), "b": (64,)}, pm)
    assert tuple(got["wte"]) == (None, None)
    assert tuple(got["b"]) == ("mp",)


def test_meshes_the_layout_cannot_split_raise():
    """Each model's build_train_step refuses, before it makes a group, a
    mesh its layout cannot split: layers over pp (the reference's
    message), the heads over mp."""
    pm = _pt_mesh((3,), ("pp",))
    with pytest.raises(ValueError, match="not divisible by pp 3"):
        pt_gpt.build_train_step(pt_gpt.GPTConfig(**GPT_KW), mesh=pm,
                                device="cpu")
    pm = _pt_mesh((8,), ("mp",))
    with pytest.raises(ValueError, match="num_heads 4 not divisible by mp"):
        pt_gpt.build_train_step(pt_gpt.GPTConfig(**GPT_KW), mesh=pm,
                                device="cpu")
    pm = _pt_mesh((4,), ("mp",))
    with pytest.raises(ValueError, match="kv heads 2"):
        pt_llama.build_train_step(pt_llama.LlamaConfig(**LLAMA_KW), mesh=pm,
                                  device="cpu")
