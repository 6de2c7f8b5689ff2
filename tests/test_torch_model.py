"""The PyTorch decoder against the JAX decoder on one weight set (CPU, f32).

JAX params come from `init_params(cfg, jax.random.key(0), jnp.float32)`, with
the norm scales and qwen biases perturbed from a numpy seed (the init leaves
them at constants that would hide a wiring mistake), and go through
`params_from_numpy`. Logits are compared at atol=1e-4: float32 on both
sides, where a whole trunk accumulates summation-order differences.

Both routes of the serving path are covered: prefill from an empty cache
through flash attention, then single-position continuation decode steps,
plus the masked continuation path over S > 1 positions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models import forward as jax_forward
from symmetry_tpu.models import init_cache as jax_init_cache
from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu.models.llama import forward_hidden as jax_forward_hidden
from symmetry_tpu.models.llama import logits_from_hidden as jax_logits
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.models.llama import (
    forward,
    forward_hidden,
    init_cache,
    init_params,
    logits_from_hidden,
    preset,
)
from symmetry_tpu_torch.ops.decode_attention import decode_attention

ATOL = 1e-4
PRESETS = ["tiny", "tiny-mha", "tiny-qwen", "tiny-gemma"]


def configs(name, window=None):
    jcfg = dataclasses.replace(jax_preset(name), sliding_window=window)
    cfg = dataclasses.replace(preset(name), sliding_window=window)
    return jcfg, cfg


def shared_params(jcfg, seed=0):
    """JAX params with perturbed norms/biases, and the same weights as
    this package's dict."""
    tree = jax.tree.map(np.asarray,
                        jax_init_params(jcfg, jax.random.key(seed),
                                        jnp.float32))
    rng = np.random.default_rng(seed)
    layers = tree["layers"]
    for name in ("attn_norm", "mlp_norm", "bq", "bk", "bv"):
        if name in layers:
            base = 0.0 if name.startswith("b") or jcfg.norm_plus_one else 1.0
            layers[name] = (base + 0.1 * rng.normal(
                size=layers[name].shape)).astype(np.float32)
    base = 0.0 if jcfg.norm_plus_one else 1.0
    tree["final_norm"] = (base + 0.1 * rng.normal(
        size=tree["final_norm"].shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jparams, params_from_numpy(tree, device="cpu")


class TestForwardParity:
    @pytest.mark.parametrize("name", PRESETS)
    def test_prefill_flash_then_decode(self, name):
        jcfg, cfg = configs(name)
        jparams, params = shared_params(jcfg)
        rng = np.random.default_rng(1)
        B, S, T = 2, 16, 32
        tokens = rng.integers(0, jcfg.vocab_size, (B, S))
        seq_lens = np.array([16, 9], np.int32)

        jcache = jax_init_cache(jcfg, B, T, jnp.float32)
        jh, jcache = jax_forward_hidden(jparams, jcfg,
                                        jnp.asarray(tokens, jnp.int32),
                                        jcache, seq_lens=jnp.asarray(seq_lens),
                                        prefill_flash=True)
        cache = init_cache(cfg, B, T, torch.float32, device="cpu")
        h, cache = forward_hidden(params, cfg, torch.from_numpy(tokens), cache,
                                  seq_lens=torch.from_numpy(seq_lens),
                                  prefill_flash=True)
        want = np.asarray(jax_logits(jparams, jcfg, jh))
        got = logits_from_hidden(params, cfg, h).numpy()
        for b, n in enumerate(seq_lens):
            np.testing.assert_allclose(got[b, :n], want[b, :n], atol=ATOL,
                                       rtol=0)

        # Continuation decode: one position per slot, ragged lengths.
        for step in range(4):
            nxt = rng.integers(0, jcfg.vocab_size, (B, 1))
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(nxt, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(nxt), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0,
                                       err_msg=f"decode step {step}")
        np.testing.assert_array_equal(cache.lengths.numpy(),
                                      np.asarray(jcache.lengths))

    @pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
    def test_continuation_path(self, name):
        """forward() from an empty cache takes the masked gqa path (S > 1,
        no prefill_flash), then a multi-position continuation."""
        jcfg, cfg = configs(name)
        jparams, params = shared_params(jcfg, seed=2)
        rng = np.random.default_rng(3)
        first = rng.integers(0, 512, (2, 8))
        more = rng.integers(0, 512, (2, 5))
        jcache = jax_init_cache(jcfg, 2, 32, jnp.float32)
        cache = init_cache(cfg, 2, 32, torch.float32, device="cpu")
        for chunk in (first, more):
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(chunk, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(chunk),
                                    cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0)

    @pytest.mark.parametrize("window", [5, 12])
    def test_sliding_window(self, window):
        jcfg, cfg = configs("tiny", window=window)
        jparams, params = shared_params(jcfg, seed=4)
        rng = np.random.default_rng(5)
        tokens = rng.integers(0, 512, (2, 32))
        seq_lens = np.array([32, 20], np.int32)
        jcache = jax_init_cache(jcfg, 2, 48, jnp.float32)
        jh, jcache = jax_forward_hidden(
            jparams, jcfg, jnp.asarray(tokens, jnp.int32), jcache,
            seq_lens=jnp.asarray(seq_lens), prefill_flash=True)
        cache = init_cache(cfg, 2, 48, torch.float32, device="cpu")
        h, cache = forward_hidden(params, cfg, torch.from_numpy(tokens),
                                  cache, seq_lens=torch.from_numpy(seq_lens),
                                  prefill_flash=True)
        for b, n in enumerate(seq_lens):
            np.testing.assert_allclose(h.numpy()[b, :n],
                                       np.asarray(jh)[b, :n], atol=ATOL,
                                       rtol=0)
        for _ in range(3):
            nxt = rng.integers(0, 512, (2, 1))
            jl, jcache = jax_forward(jparams, jcfg,
                                     jnp.asarray(nxt, jnp.int32), jcache)
            logits, cache = forward(params, cfg, torch.from_numpy(nxt), cache)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=0)


class TestModelSurface:
    def test_cache_written_in_place(self):
        cfg = preset("tiny")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
        cache = init_cache(cfg, 1, 16, torch.float32, device="cpu")
        k_before = cache.k
        _, cache = forward(params, cfg, torch.tensor([[3, 4, 5]]), cache)
        assert cache.k is k_before
        assert cache.k[:, 0, :3].abs().sum() > 0
        assert cache.k[:, 0, 3:].abs().sum() == 0

    def test_init_params_layout_matches_jax(self):
        cfg = preset("tiny-qwen")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
        jtree = jax.tree.map(np.asarray,
                             jax_init_params(jax_preset("tiny-qwen"),
                                             jax.random.key(0), jnp.float32))
        assert params.keys() == jtree.keys()
        assert params["layers"].keys() == jtree["layers"].keys()
        for k, v in params["layers"].items():
            assert tuple(v.shape) == jtree["layers"][k].shape, k

    def test_bf16_params_convert(self):
        tree = jax.tree.map(np.asarray,
                            jax_init_params(jax_preset("tiny"),
                                            jax.random.key(0), jnp.bfloat16))
        params = params_from_numpy(tree, device="cpu")
        assert params["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(params["embed"].float().numpy(),
                                      tree["embed"].astype(np.float32))

    def test_moe_refused(self):
        """Once a refusal (MoE was ROADMAP item 13); now `tiny-moe` draws
        the JAX package's tree: the router and the [L, X, ...] expert
        stacks, key for key and shape for shape."""
        params = init_params(preset("tiny-moe"), torch.Generator(),
                             torch.float32)
        jtree = jax_init_params(jax_preset("tiny-moe"), jax.random.key(0),
                                jnp.float32)
        assert params.keys() == jtree.keys()
        assert params["layers"].keys() == jtree["layers"].keys()
        for k, v in params["layers"].items():
            assert tuple(v.shape) == jtree["layers"][k].shape, k
        assert params["layers"]["wg"].shape == (2, 4, 64, 128)
        assert params["layers"]["wd"].shape == (2, 4, 128, 64)
        assert params["layers"]["router"].shape == (2, 64, 4)

    def test_quantized_cache_refused(self):
        """An int8 cache comes in the JAX layout ([L, B, T, K, D] int8 with
        [L, B, K, T] float32 scale planes); its payload without the scale
        planes is refused by decode attention."""
        cache = init_cache(preset("tiny"), 1, 8, quantized=True,
                           device="cpu")
        assert cache.quantized and cache.k.dtype == torch.int8
        assert cache.k.shape == (2, 1, 8, 2, 16)
        assert cache.k_scale.shape == (2, 1, 2, 8)
        assert cache.k_scale.dtype == torch.float32
        with pytest.raises(ValueError, match="scale"):
            decode_attention(torch.zeros((1, 4, 16)), cache.k, cache.v, 0,
                             torch.ones(1, dtype=torch.int32))

    def test_ring_mesh_refused(self):
        """Sequence-parallel prefill serves a context-only mesh and, since
        item 14 closed, one with a model axis too (tests/test_torch_cp.py):
        what it refuses there is the JAX functions' own case, a sequence
        the context axis does not divide, in their words, before any layer
        runs; and without the empty-cache contract, in the JAX words."""
        from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec

        cfg = preset("tiny")
        params = init_params(cfg, torch.Generator(), torch.float32)
        for mode, words in (("ring", "ring size 2"),
                            ("ulysses", "shard count 2")):
            with pytest.raises(ValueError,
                               match=f"sequence 3 not divisible by {words}"):
                forward_hidden(params, cfg,
                               torch.zeros((1, 3), dtype=torch.long),
                               init_cache(cfg, 1, 8, torch.float32,
                                          device="cpu"),
                               prefill_flash=True, sp_mode=mode,
                               ring_mesh=Mesh(MeshSpec(context=2, model=2)))
        with pytest.raises(ValueError, match="prefill_flash"):
            forward_hidden(params, cfg, torch.zeros((1, 4), dtype=torch.long),
                           init_cache(cfg, 1, 8, torch.float32, device="cpu"),
                           ring_mesh=Mesh(MeshSpec(context=2)))

    def test_depth_mismatch_raises(self):
        cfg = preset("tiny")
        params = init_params(dataclasses.replace(cfg, num_layers=3),
                             torch.Generator(), torch.float32)
        with pytest.raises(ValueError, match="stacked layers"):
            forward(params, cfg, torch.zeros((1, 2), dtype=torch.long),
                    init_cache(cfg, 1, 8, torch.float32, device="cpu"))
