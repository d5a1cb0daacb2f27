"""Greedy pattern rewriting (the pir header pattern_rewrite_driver.h).

Patterns match one OpNode at a time and edit the graph through a Rewriter
(pir's PatternRewriter facade). The rewriter worklists until fixpoint, like
ApplyPatternsGreedily.
"""
from __future__ import annotations

from typing import List

from .pass_base import Pass, Workspace


class Rewriter:
    """Mutation facade handed to patterns (pir PatternRewriter analog).

    Maintains a producer index (id(output var) -> defining op) so patterns
    match producers in O(1) instead of rescanning the op list."""

    def __init__(self, ws: Workspace):
        self.ws = ws
        self.changed = False
        self._producers = {id(o): n for n in ws.ops for o in n.outputs}

    def producer_of(self, var):
        return self._producers.get(id(var))

    def erase_op(self, node):
        if node in self.ws.ops:
            self.ws.ops.remove(node)
            for o in node.outputs:
                self._producers.pop(id(o), None)
            self.changed = True

    def insert_before(self, anchor, node):
        self.ws.ops.insert(self.ws.ops.index(anchor), node)
        for o in node.outputs:
            self._producers[id(o)] = node
        self.changed = True

    def replace_all_uses(self, old_var, new_val):
        self.ws.replace_all_uses(old_var, new_val)
        self.changed = True

    def replace_op(self, node, new_vals):
        """Replace node's outputs with new values and erase it."""
        for out, nv in zip(node.outputs, new_vals):
            self.replace_all_uses(out, nv)
        self.erase_op(node)


class RewritePattern:
    """Subclass and implement match_and_rewrite (pir RewritePattern)."""

    # ops this pattern anchors on; empty = all
    root_ops: tuple = ()

    def match_and_rewrite(self, node, rewriter: Rewriter) -> bool:
        raise NotImplementedError


class PatternRewriter(Pass):
    """Pass that greedily applies a frozen pattern set to fixpoint
    (FrozenRewritePatternSet + GreedyRewriteConfig analog)."""

    name = "pattern_rewriter"

    def __init__(self, patterns: List[RewritePattern], max_iters: int = 10):
        self.patterns = list(patterns)
        self.max_iters = max_iters

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        changed_any = False
        for _ in range(self.max_iters):
            rw = Rewriter(ws)
            for node in list(ws.ops):
                if node not in ws.ops:
                    continue  # erased by an earlier pattern this sweep
                for pat in self.patterns:
                    if pat.root_ops and node.op_name not in pat.root_ops:
                        continue
                    if pat.match_and_rewrite(node, rw):
                        break
            if not rw.changed:
                break
            changed_any = True
        return changed_any
