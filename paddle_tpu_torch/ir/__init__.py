"""paddle.ir: the counterpart of ``paddle_tpu/ir``, pass infrastructure
over the programs ``paddle_tpu_torch.static`` records.

Analog of the reference's PIR pass layer: PassManager + Pass
(paddle/pir/include/pass/pass.h, pass_manager.h), the greedy pattern
rewriter (paddle/pir/include/pattern_rewrite/pattern_rewrite_driver.h,
frozen_rewrite_pattern_set.h), and the stock general transforms
(paddle/fluid/pir/transforms/general/: constant_folding_pass.cc,
common_subexpression_elimination_pass.cc, dead_code_elimination_pass.cc,
auto_mixed_precision_pass.cc).

The passes stay at the graph-semantics level (folding, dedup, dead-op
removal, precision and layout rewrites) and leave kernel fusion and
scheduling to the compiler the executor hands the program to
(``torch.compile``). Passes run on a Workspace (a transformed compilation
view of a Program) so the user's recorded Program is never mutated and
executor cache keys stay stable.
"""
from .pass_base import Pass, PassManager, Workspace
from .pattern_rewrite import PatternRewriter, RewritePattern, Rewriter
from .passes import (
    AutoMixedPrecisionPass,
    CommonSubexpressionEliminationPass,
    ConstantFoldingPass,
    DeadCodeEliminationPass,
    default_pass_manager,
)

__all__ = [
    "Pass", "PassManager", "Workspace",
    "RewritePattern", "PatternRewriter", "Rewriter",
    "ConstantFoldingPass", "DeadCodeEliminationPass",
    "CommonSubexpressionEliminationPass", "AutoMixedPrecisionPass",
    "default_pass_manager",
]
