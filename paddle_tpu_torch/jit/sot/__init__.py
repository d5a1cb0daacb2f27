"""SOT: bytecode-level symbolic graph capture with graph-break fallback;
the counterpart of ``paddle_tpu/jit/sot`` (the reference Paddle's jit/sot
stack
python/paddle/jit/sot/opcode_translator/executor/opcode_executor.py:1880,
eval_frame_callback.py, function_graph.py, guard.py). User functions are
captured by SYMBOLICALLY EXECUTING THEIR BYTECODE, guarding the Python
values the execution depended on, and falling back — never raising — on
anything the capture cannot express:

- tensor ops recorded into the lazy window (``_core/lazy.py``), one
  segment per stretch between breaks;
- a data-dependent tensor branch, a print, .numpy(), or an unsupported
  library call simply MATERIALIZES the pending segment (graph break) and
  capture resumes into a new segment — results stay correct;
- frames the executor cannot interpret at all (generators, try/except,
  closures creating cells) run natively, still under the lazy capture,
  so compiled segments are produced even on the fallback path;
- clean captures (single segment, no breaks, no mutations) install a
  guarded FAST PATH: later calls check the guards and run the segment,
  compiled with ``jit.api.compile_traced`` (inductor on the card,
  ``aot_eager`` on the CPU), skipping Python bytecode entirely — the
  eval-frame replacement role of the reference's pycode_generator.

Where the reference generates resume code objects per graph break, this
build re-interprets broken functions per call (segment runners stay cached, so
steady-state cost is one cache lookup + one runner call per segment):
the interpreter IS the resume mechanism. This trades peak Python speed
on broken functions for a drastically simpler and fully sound runtime.
"""
from .opcode_executor import (SotFallback, SotFunction,  # noqa: F401
                              SotSideEffectError, symbolic_translate,
                              sot_stats)

__all__ = ["symbolic_translate", "SotFunction", "SotFallback", "sot_stats"]
