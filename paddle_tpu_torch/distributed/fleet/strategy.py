"""``DistributedStrategy``: the counterpart of
``paddle_tpu/distributed/fleet/strategy.py``.

A plain attribute bag with the reference's keys and defaults (upstream
Paddle backs it with a protobuf). ``hybrid_configs`` gives the degrees of
the ``HybridCommunicateGroup``'s axes. Assigning a dict to one of the
``*_configs`` bags merges it into the defaults, as the protobuf does:
``strategy.hybrid_configs = {"mp_degree": 2}`` keeps the other keys.
"""
from __future__ import annotations


class _Bag(dict):
    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError:
            raise AttributeError(k)

    def __setattr__(self, k, v):
        self[k] = v


class DistributedStrategy:
    def __setattr__(self, k, v):
        cur = self.__dict__.get(k)
        if isinstance(cur, _Bag) and isinstance(v, dict) \
                and not isinstance(v, _Bag):
            cur.update(v)
            return
        object.__setattr__(self, k, v)

    def __init__(self):
        self.amp = False
        self.amp_configs = _Bag(init_loss_scaling=32768.0, use_pure_bf16=False,
                                custom_white_list=[], custom_black_list=[],
                                level="O1")
        self.recompute = False
        self.recompute_configs = _Bag(checkpoints=[])
        self.sharding = False
        self.sharding_configs = _Bag(stage=1, degree=1, comm_overlap=False)
        self.pipeline = False
        self.pipeline_configs = _Bag(accumulate_steps=1, micro_batch_size=1,
                                     schedule_mode="1F1B")
        self.hybrid_configs = _Bag(
            dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
            sep_degree=1, order=["dp", "pp", "sharding", "sep", "mp"],
            mp_configs=_Bag(sync_param=False, sync_grad=False,
                            sync_moment=False),
            pp_configs=_Bag(delay_scale_loss=False, enable_timer=False),
        )
        self.hybrid_parallel_order = ["dp", "pp", "sharding", "sep", "mp"]
        self.gradient_merge = False
        self.gradient_merge_configs = _Bag(k_steps=1, avg=True)
        self.lamb = False
        self.dgc = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.without_graph_optimization = False
        self.find_unused_parameters = False
        self.tensor_parallel = False
        self.tensor_parallel_configs = _Bag(tensor_parallel_degree=1)
        self.heter_ccl_mode = False
        self.a_sync = False
        self.a_sync_configs = _Bag(k_steps=-1)

    def __repr__(self):
        keys = ["hybrid_configs", "amp", "recompute", "sharding", "pipeline"]
        return "DistributedStrategy(" + ", ".join(
            f"{k}={getattr(self, k)}" for k in keys) + ")"
