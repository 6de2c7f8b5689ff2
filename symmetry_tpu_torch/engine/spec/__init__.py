"""Speculative decoding subsystem (off by default; `tpu.speculative`).

Three pieces, one per layer of the serving stack:

  - drafter.py (host): per-slot n-gram prompt-lookup index proposing up
    to k_draft continuation tokens per slot per block — no draft model.
  - ops/sampling.py verify_tokens (device): per-position acceptance
    against the target distribution — exact for greedy lanes, unbiased
    rejection sampling for temperature/top-p/top-k lanes.
  - engine.py verify_step + scheduler integration: ONE batched
    [B, 1 + k_draft] forward verifies every slot's proposals, rolls each
    slot's cache length back to its first rejection, and the scheduler
    emits the variable-length accepted spans through the existing
    block-granular event frames.
"""

from symmetry_tpu_torch.engine.spec.drafter import NGramDrafter, SpecConfig

__all__ = ["NGramDrafter", "SpecConfig"]
