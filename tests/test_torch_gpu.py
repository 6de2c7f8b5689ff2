"""The CUDA kernels and the engine on the card (marker `gpu`).

Each kernel is held against its plain PyTorch version on the same inputs on
the card: atol 1e-4 in float32 (TF32 off; only summation order differs) and
2e-2 in bfloat16 (the plain version rounds its inputs the same way but sums
in another order). Every test skips here, with its reason, when no CUDA
device is present. This file imports nothing of JAX, so on the card it runs
without the JAX package's test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from symmetry_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_reference,
)
from symmetry_tpu_torch.ops.flash import flash_prefill, flash_prefill_reference


def cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run `python -m pytest --noconftest "
                    "-m gpu tests/test_torch_gpu.py` on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make_case(B=3, T=64, K=2, G=4, D=128, L=2, seed=0, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, K * G, D)).astype(np.float32)
    k = rng.normal(size=(L, B, T, K, D)).astype(np.float32)
    v = rng.normal(size=(L, B, T, K, D)).astype(np.float32)
    # ragged: slot 0 nearly full, slot 1 short, slot 2 mid
    if lengths is None:
        lengths = [T - 3, 5, T // 2][:B]
    return q, k, v, np.asarray(lengths, np.int32)


def case(seed, B, S, nq, nkv, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, nq, D)).astype(dtype)
    k = rng.normal(size=(B, S, nkv, D)).astype(dtype)
    v = rng.normal(size=(B, S, nkv, D)).astype(dtype)
    return q, k, v


@pytest.mark.gpu
class TestFlashKernel:
    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    @pytest.mark.parametrize("S,window", [(16, None), (96, None), (256, None),
                                          (256, 40), (128, 64)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain(self, D, S, window, dtype):
        dev = cuda_or_skip()
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in case(7, 3, S, 8, 2, D))
        seq_lens = torch.tensor([S, S // 3 + 1, 1], dtype=torch.int32,
                                device=dev)
        before = flash_prefill.launches
        got = flash_prefill(q, k, v, seq_lens, window=window)
        torch.cuda.synchronize()
        assert flash_prefill.launches == before + 1
        want = flash_prefill_reference(q, k, v, seq_lens, window=window)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        assert torch.isfinite(got).all()
        for b, n in enumerate(seq_lens.tolist()):
            torch.testing.assert_close(got[b, :n].float(),
                                       want[b, :n].float(), atol=tol, rtol=0)

    def test_strided_inputs(self):
        """q/k/v as views of one fused projection, read through strides."""
        dev = cuda_or_skip()
        B, S, H, K, D = 2, 128, 8, 2, 64
        qkv = torch.randn(B, S, H + 2 * K, D, device=dev)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        seq_lens = torch.tensor([128, 70], dtype=torch.int32, device=dev)
        got = flash_prefill(q, k, v, seq_lens)
        want = flash_prefill_reference(q, k, v, seq_lens)
        torch.testing.assert_close(got[0], want[0], atol=1e-4, rtol=0)
        torch.testing.assert_close(got[1, :70], want[1, :70], atol=1e-4,
                                   rtol=0)

    def test_rejects_mismatched_dtype(self):
        dev = cuda_or_skip()
        q = torch.zeros((1, 16, 2, 16), device=dev)
        with pytest.raises(TypeError):
            flash_prefill(q, q.bfloat16(), q, torch.ones(1, dtype=torch.int32,
                                                         device=dev))

@pytest.mark.gpu
class TestDecodeAttentionKernel:
    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    @pytest.mark.parametrize("G", [1, 2, 4, 8])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [None, 37])
    def test_kernel_matches_plain(self, D, G, dtype, window):
        dev = cuda_or_skip()
        T = 160
        q, k, v, lengths = make_case(B=4, T=T, K=2, G=G, D=D, L=3, seed=11,
                                     lengths=[0, 1, 77, T])
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in (q, k, v))
        lengths = torch.from_numpy(lengths).to(dev)
        before = decode_attention.launches
        got = decode_attention(q, k, v, 2, lengths, window=window)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert torch.isfinite(got).all()
        want = decode_attention_reference(q, k, v, 2, lengths, window=window)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        # slot 0 is empty: garbage by contract
        torch.testing.assert_close(got[1:].float(), want[1:].float(),
                                   atol=tol, rtol=0)

    def test_length_past_capacity_reads_capacity(self):
        dev = cuda_or_skip()
        q, k, v, _ = make_case(B=2, T=64, seed=12)
        q, k, v = (torch.from_numpy(a).to(dev) for a in (q, k, v))
        over = torch.tensor([64, 500], dtype=torch.int32, device=dev)
        got = decode_attention(q, k, v, 0, over)
        want = decode_attention(q, k, v, 0, torch.full_like(over, 64))
        torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.gpu
class TestEngineOnCard:
    def test_tiny_greedy_card_equals_cpu(self):
        """The tiny preset served on the card (kernels) and on the CPU
        (plain versions) from the same float32 weights: greedy ids match."""
        from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                      SamplingParams)
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
        from symmetry_tpu_torch.models.llama import init_params, preset

        dev = cuda_or_skip()
        cfg = preset("tiny")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
        prompts = [[5, 6, 7], list(range(20, 40)), [300] * 9]

        def run(device):
            engine = InferenceEngine(cfg, params, ByteTokenizer(512),
                                     max_slots=4, max_seq_len=64,
                                     prefill_buckets=(16, 32),
                                     cache_dtype=torch.float32,
                                     decode_block=4, device=device)
            firsts = engine.prefill_and_insert_many(
                [(i, p, SamplingParams()) for i, p in enumerate(prompts)])
            blocks = [np.asarray(engine.decode_steps_dispatch())
                      for _ in range(4)]
            return firsts, np.concatenate(blocks)[:, :len(prompts)]

        f_card, t_card = run(dev)
        f_cpu, t_cpu = run("cpu")
        assert f_card == f_cpu
        np.testing.assert_array_equal(t_card, t_cpu)
