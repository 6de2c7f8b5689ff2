"""symmetry-tpu's serving engine in PyTorch, with hand-written CUDA kernels.

A second package beside `symmetry_tpu` (the JAX reference). It mirrors that
package's layout so each module's counterpart is found by path:

  - ops/     RoPE, RMSNorm, attention, sampling, and the two CUDA kernels of
             the serving path (flash prefill, decode attention), each beside
             its plain PyTorch version;
  - models/  the llama-family decoder over a stacked-layer parameter dict;
  - engine/  InferenceEngine (prefill / insert / decode over a slot batch)
             and its own copy of the continuous-batching Scheduler;
  - utils/   logging, faults, metrics, tracing and JSON (copies, no device
             code);
  - protocol/, identity/, transport/, network/, server/, client/,
    provider/  the P2P network, the routing server, the client and the
             provider with its backends: copies of the JAX package's, whose
             tpu_native backend serves this package's engine.

The package imports torch and numpy only: never jax, never `symmetry_tpu`.
Entry points run on "cuda" unless the caller passes device="cpu"; on the
CPU each kernel's plain version runs in its place.
"""

__version__ = "0.1.0"
