"""Pass / PassManager / Workspace (pir pass.h + pass_manager.h analog):
the counterpart of ``paddle_tpu/ir/pass_base.py``."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

# ops whose results are not pure functions of their inputs — never fold,
# dedupe, reorder, or drop across these (pir marks these via op traits)
IMPURE_MARKERS = ("rand", "dropout", "uniform", "normal", "bernoulli",
                  "poisson", "multinomial", "exponential", "seed",
                  "print", "assign_out", "share_data")


def is_impure(op_name: str) -> bool:
    return any(m in op_name for m in IMPURE_MARKERS)


class Workspace:
    """A transformed compilation view of a recorded Program.

    Shallow-copies the op list (fresh OpNode shells, shared Variable
    objects) so passes can mutate freely; the original Program — which
    users may keep recording into or re-fetch from — is untouched.
    Replacements are expressed as:

    - ``aliases``:   id(Variable) -> Variable   (CSE: use other op's out)
    - ``const_env``: id(Variable) -> torch tensor (folded constants)

    The executor's replay consults both when resolving op inputs and
    fetch targets.
    """

    def __init__(self, program):
        from ..static import OpNode
        self.program = program
        self.ops = [OpNode(n.op_name, dict(n.attrs), list(n.inputs),
                           list(n.outputs), n.fn) for n in program.ops]
        self.feed_vars = list(program.feed_vars)
        self.aliases: Dict[int, Any] = {}
        self.const_env: Dict[int, Any] = {}

    # ------------------------------------------------------------ helpers
    def resolve(self, var):
        """Follow alias chains to the canonical value/variable."""
        seen = set()
        while id(var) in self.aliases and id(var) not in seen:
            seen.add(id(var))
            var = self.aliases[id(var)]
        return var

    def replace_all_uses(self, old_var, new_val):
        """Point every use of old_var (and its aliases) at new_val."""
        from ..static import Variable
        if isinstance(new_val, Variable):
            self.aliases[id(old_var)] = new_val
        else:
            # a concrete constant: store the raw tensor so the compiled
            # replay never returns a wrapper object
            self.const_env[id(old_var)] = (
                new_val._t if hasattr(new_val, "_t") else new_val)
        for node in self.ops:
            for i, t in enumerate(node.inputs):
                if t is old_var:
                    node.inputs[i] = new_val


class Pass:
    """Base pass: ``run(workspace, protected) -> bool changed``.

    ``protected`` is the set of id(Variable) that must stay computable
    (fetch targets) — the pir analog keeps these alive through its
    analysis-preserved values.
    """

    name = "pass"

    def run(self, ws: Workspace, protected: frozenset) -> bool:
        raise NotImplementedError


class PassManager:
    """Ordered pass pipeline with per-pass timing instrumentation
    (pir PassManager + IRPrinting hooks analog). ``FLAGS_ir_pass_disable``
    names passes to skip."""

    def __init__(self, passes: Optional[Sequence[Pass]] = None,
                 iterate_to_fixpoint: bool = False, max_iters: int = 8):
        self.passes: List[Pass] = list(passes or [])
        self.iterate_to_fixpoint = iterate_to_fixpoint
        self.max_iters = max_iters
        self.stats: List[Dict] = []

    def add_pass(self, p: Pass):
        self.passes.append(p)
        return self

    def run(self, ws: Workspace,
            protected: Sequence = ()) -> bool:
        from .._core.flags import flag_value
        disabled = {n.strip()
                    for n in flag_value("FLAGS_ir_pass_disable").split(",")
                    if n.strip()}
        prot = frozenset(id(v) for v in protected)
        changed_any = False
        for _ in range(self.max_iters if self.iterate_to_fixpoint else 1):
            round_changed = False
            for p in self.passes:
                if p.name in disabled:
                    continue
                t0 = time.perf_counter()
                changed = bool(p.run(ws, prot))
                self.stats.append({
                    "pass": p.name, "changed": changed,
                    "ms": (time.perf_counter() - t0) * 1e3})
                round_changed |= changed
            changed_any |= round_changed
            if not round_changed:
                break
        return changed_any
