"""The PyTorch serving engine: InferenceEngine over a slot-batched KV cache
(engine.py), the continuous-batching Scheduler that drives it
(scheduler.py, a copy of the JAX package's), and the host-only tokenizer
and cost ledger it needs.
"""
