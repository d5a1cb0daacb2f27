"""ResNet-50's compiled training step held against the eager one beside
what rounding alone does to the same comparison, on one CUDA card.

    python3 chip_compile_witness.py [--steps 3]

From the root of a checkout, on a machine with one CUDA card. Runs
``chip_smoke.resnet_divergence`` (``bench_suite.py``'s ResNet-50 workload:
``Momentum(0.1)``, batch 64 x 224^2, one batch, seed 0) four times, with
inductor's cache in a fresh directory and TF32 off: under O1 bf16 and in
fp32, each with the models running free and with each step started from
the eager model's state. Each run trains four models from the same seed:
eager, ``@to_static`` (inductor), an eager twin on the same batch, and an
eager twin on the batch's samples in another order (the same step in
exact arithmetic; only summation orders change). Each is printed against
the eager model step by step: the loss, the gradients, the update and
the BN running statistics. Nothing is checked: the readings say whether
the compiled model's drift from eager is of the size a change of
summation order alone gives, and whether it stays one step's rounding
when each step starts from the same state.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke as cs
    _, _, smi = cs.card()  # TF32 off from here on
    cache = tempfile.mkdtemp(prefix="inductor_")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = cache
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    try:
        for amp in (True, False):
            for forced in (False, True):
                t0 = time.perf_counter()
                cs.resnet_divergence(smi, amp, ("same", "permuted"), forced,
                                     steps=args.steps)
                torch.cuda.empty_cache()
                print(f"run {time.perf_counter() - t0:.1f} s on {smi}",
                      flush=True)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
