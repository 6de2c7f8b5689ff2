"""The CUDA kernels and the engine on the card (marker `gpu`).

Each kernel is held against its plain PyTorch version on the same inputs on
the card: atol 1e-4 in float32 (TF32 off; only summation order differs) and
2e-2 in bfloat16 (the plain version rounds its inputs the same way but sums
in another order; the tensor-core flash kernel also rounds its softmax
probabilities to bf16 before the P V product, as the JAX kernel rounds p to
the value dtype, where the plain version keeps them in float32: about 2**-9
relative on each weight, below one bf16 step of the output); the KV append
bit for bit; W8A16 relative to its output's magnitude. Every test skips here, with its reason, when no CUDA
device is present. This file imports nothing of JAX, so on the card it runs
without the JAX package's test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from symmetry_tpu_torch.ops.decode_attention import (
    SPAN,
    decode_attention,
    decode_attention_reference,
)
from symmetry_tpu_torch.ops.flash import (
    flash_prefill,
    flash_prefill_reference,
    flash_variant,
)
from symmetry_tpu_torch.ops.kv_append import kv_append, kv_append_reference
from symmetry_tpu_torch.ops.qmm import (
    w8a8_matmul,
    w8a8_plan,
    w8a8_reference,
    w8a16_matmul,
    w8a16_reference,
    w8a16_regime,
)
from symmetry_tpu_torch.ops.quant import pack_quantized, quantize, quantize_kv


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

    @pytest.mark.parametrize("D", [24, 80, 96, 112, 192])
    @pytest.mark.parametrize("S,window", [(96, None), (256, 40)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_head_dims_between_built_sizes(self, D, S, window, dtype):
        """A head dim that is no built size runs at the next one (bf16 above
        32 on the tensor cores, the rest on FMAs), its columns past D zero,
        its scale from D, only D columns stored."""
        dev = cuda_or_skip()
        q, k, v = (torch.from_numpy(a).to(dev, dtype)
                   for a in case(8, 3, S, 8, 2, D))
        seq_lens = torch.tensor([S, S // 3 + 1, 1], dtype=torch.int32,
                                device=dev)
        variant = flash_variant(dtype, D)
        assert variant == ("tensor_core" if dtype == torch.bfloat16
                           and D > 32 else "fma")
        before = flash_prefill.variant_launches[variant]
        got = flash_prefill(q, k, v, seq_lens, window=window)
        torch.cuda.synchronize()
        assert flash_prefill.variant_launches[variant] == before + 1
        assert got.shape == q.shape and torch.isfinite(got).all()
        want = flash_prefill_reference(q, k, v, seq_lens, window=window)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
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

    def check_bf16(self, B, S, H, K, D, lens, window=None, seed=21):
        """One bf16 call at llama-like widths against the plain version on
        valid rows; the tensor-core variant must have taken it."""
        dev = cuda_or_skip()
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in case(seed, B, S, H, K, D))
        seq_lens = torch.tensor(lens, dtype=torch.int32, device=dev)
        assert flash_variant(q.dtype, D) == "tensor_core"
        before = flash_prefill.variant_launches["tensor_core"]
        got = flash_prefill(q, k, v, seq_lens, window=window)
        torch.cuda.synchronize()
        assert flash_prefill.variant_launches["tensor_core"] == before + 1
        want = flash_prefill_reference(q, k, v, seq_lens, window=window)
        assert torch.isfinite(got).all()
        for b, n in enumerate(lens):
            torch.testing.assert_close(got[b, :n].float(),
                                       want[b, :n].float(), atol=2e-2,
                                       rtol=0)

    @pytest.mark.parametrize("S", [16, 32, 64, 2048])
    def test_tensor_core_buckets(self, S):
        """Buckets smaller than one 128-row tile, and the largest."""
        self.check_bf16(2, S, 32, 8, 128, [S, S // 2 + 1])

    def test_tensor_core_ragged_batch(self):
        self.check_bf16(4, 2048, 32, 8, 128, [2048, 1900, 1025, 17])

    @pytest.mark.parametrize("D", [64, 128, 256])
    @pytest.mark.parametrize("window", [130, 200])
    def test_tensor_core_window_crosses_tile_edge(self, D, window):
        self.check_bf16(2, 512, 8, 2, D, [512, 333], window=window)

    def test_strided_inputs_bf16(self):
        """bf16 q/k/v as views of one fused projection: the tensor-core
        kernel reads them through their strides."""
        dev = cuda_or_skip()
        B, S, H, K, D = 2, 256, 8, 2, 128
        qkv = torch.randn(B, S, H + 2 * K, D, device=dev,
                          dtype=torch.bfloat16)
        q, k, v = qkv[:, :, :H], qkv[:, :, H:H + K], qkv[:, :, H + K:]
        seq_lens = torch.tensor([256, 70], dtype=torch.int32, device=dev)
        before = flash_prefill.variant_launches["tensor_core"]
        got = flash_prefill(q, k, v, seq_lens)
        assert flash_prefill.variant_launches["tensor_core"] == before + 1
        want = flash_prefill_reference(q, k, v, seq_lens)
        torch.testing.assert_close(got[0].float(), want[0].float(),
                                   atol=2e-2, rtol=0)
        torch.testing.assert_close(got[1, :70].float(), want[1, :70].float(),
                                   atol=2e-2, rtol=0)

    def test_tensor_core_rejects_unaligned_rows(self):
        """A bf16 view whose rows are not 16-byte aligned raises; it is
        never routed to the other kernel."""
        dev = cuda_or_skip()
        flat = torch.zeros(1 + 16 * 2 * 64, device=dev, dtype=torch.bfloat16)
        q = flat[1:].view(1, 16, 2, 64)
        lens = torch.ones(1, dtype=torch.int32, device=dev)
        before = dict(flash_prefill.variant_launches)
        with pytest.raises(ValueError, match="16-byte"):
            flash_prefill(q, q, q, lens)
        assert flash_prefill.variant_launches == before

@pytest.mark.gpu
class TestDecodeAttentionKernel:
    @pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
    @pytest.mark.parametrize("G", [1, 2, 3, 4, 5, 6, 7, 8, 16])
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

    @pytest.mark.parametrize("D", [16, 64, 128, 256])
    @pytest.mark.parametrize("G", [1, 4, 7, 8, 16])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("window", [None, 37])
    def test_int8_kernel_matches_plain(self, D, G, dtype, window):
        """int8 payload + position-minor scales: the k scale multiplies the
        scores and the v scale the probabilities, in the kernel and in
        gqa_attention (which also rounds the probabilities to q's dtype;
        hence 2e-2 in bf16, 1e-4 in float32)."""
        dev = cuda_or_skip()
        T = 160
        q, k, v, lengths = make_case(B=4, T=T, K=2, G=G, D=D, L=3, seed=13,
                                     lengths=[0, 1, 77, T])
        kq, ks = quantize_kv(torch.from_numpy(k))
        vq, vs = quantize_kv(torch.from_numpy(v))
        ks, vs = (s.transpose(-1, -2).contiguous().to(dev) for s in (ks, vs))
        kq, vq = kq.to(dev), vq.to(dev)
        q = torch.from_numpy(q).to(dev, dtype)
        lengths = torch.from_numpy(lengths).to(dev)
        before = decode_attention.launches
        got = decode_attention(q, kq, vq, 2, lengths, ks, vs, window=window)
        torch.cuda.synchronize()
        assert decode_attention.launches == before + 1
        assert torch.isfinite(got).all()
        want = decode_attention_reference(q, kq, vq, 2, lengths, ks, vs,
                                          window=window)
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got[1:].float(), want[1:].float(),
                                   atol=tol, rtol=0)

    @pytest.mark.parametrize("D", [24, 40, 80, 88, 96, 112, 192])
    @pytest.mark.parametrize("kind", ["bfloat16", "int8"])
    def test_head_dims_between_built_sizes(self, D, kind):
        """A head dim that is no built size runs at the next one: copies
        past D zero-filled (8-byte copies for int8 rows of 8 mod 16 bytes:
        24, 40, 88), q zero there, D columns stored."""
        dev = cuda_or_skip()
        T = 300
        q, k, v, lengths = make_case(B=4, T=T, K=2, G=4, D=D, L=2, seed=19,
                                     lengths=[0, 1, 130, T])
        q = torch.from_numpy(q).to(dev, torch.bfloat16)
        if kind == "int8":
            (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x))
                                  for x in (k, v))
            ks, vs = (s.transpose(-1, -2).contiguous().to(dev)
                      for s in (ks, vs))
            kc, vc = kq.to(dev), vq.to(dev)
        else:
            kc, vc = (torch.from_numpy(x).to(dev, torch.bfloat16)
                      for x in (k, v))
            ks = vs = None
        lengths = torch.from_numpy(lengths).to(dev)
        got = decode_attention(q, kc, vc, 1, lengths, ks, vs, window=None)
        torch.cuda.synchronize()
        assert got.shape == q.shape and torch.isfinite(got).all()
        want = decode_attention_reference(q, kc, vc, 1, lengths, ks, vs)
        torch.testing.assert_close(got[1:].float(), want[1:].float(),
                                   atol=2e-2, rtol=0)

    @pytest.mark.parametrize("int8", [False, True])
    def test_qwen2_group_of_seven(self, int8):
        """qwen2-7b heads: 28 query heads over 4 KV heads, D = 128."""
        dev = cuda_or_skip()
        q, k, v, lengths = make_case(B=3, T=96, K=4, G=7, D=128, L=2,
                                     seed=14, lengths=[96, 50, 3])
        q = torch.from_numpy(q).to(dev, torch.bfloat16)
        lengths = torch.from_numpy(lengths).to(dev)
        if int8:
            (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a))
                                  for a in (k, v))
            caches = (kq.to(dev), vq.to(dev))
            scales = tuple(s.transpose(-1, -2).contiguous().to(dev)
                           for s in (ks, vs))
        else:
            caches = tuple(torch.from_numpy(a).to(dev, torch.bfloat16)
                           for a in (k, v))
            scales = (None, None)
        got = decode_attention(q, *caches, 1, lengths, *scales)
        want = decode_attention_reference(q, *caches, 1, lengths, *scales)
        assert got.shape == (3, 28, 128)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                                   rtol=0)

    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("window", [None, 300])
    def test_span_edges(self, kind, window):
        """Lengths on, one before and one past a span edge, a full slot, an
        empty one; a window floor that crosses spans."""
        dev = cuda_or_skip()
        T = 4 * SPAN
        lengths = [SPAN - 1, SPAN, SPAN + 1, 2 * SPAN, T, 0, 1, 700]
        q, k, v, lengths = make_case(B=8, T=T, K=2, G=4, D=128, L=2,
                                     seed=15, lengths=lengths)
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        q = torch.from_numpy(q).to(dev, dtype)
        lengths = torch.from_numpy(lengths).to(dev)
        if kind == "int8":
            (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a))
                                  for a in (k, v))
            caches = (kq.to(dev), vq.to(dev))
            scales = tuple(s.transpose(-1, -2).contiguous().to(dev)
                           for s in (ks, vs))
        else:
            caches = tuple(torch.from_numpy(a).to(dev, dtype)
                           for a in (k, v))
            scales = (None, None)
        got = decode_attention(q, *caches, 1, lengths, *scales, window=window)
        want = decode_attention_reference(q, *caches, 1, lengths, *scales,
                                          window=window)
        assert torch.isfinite(got).all()
        live = lengths > 0
        tol = 1e-4 if kind == "float32" else 2e-2
        torch.testing.assert_close(got[live].float(), want[live].float(),
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
class TestNoHostSync:
    def test_attention_wrappers_never_synchronize(self):
        """Flash (both variants) and decode (bf16 and int8) launch under
        torch.cuda.set_sync_debug_mode("error"), which raises on any call
        that synchronizes the host with the card."""
        dev = cuda_or_skip()
        q, k, v = (torch.from_numpy(a).to(dev)
                   for a in case(3, 2, 256, 8, 2, 128))
        seq_lens = torch.tensor([256, 99], dtype=torch.int32, device=dev)
        qd, kd, vd, lengths = make_case(B=4, T=600, seed=16,
                                        lengths=[600, 0, 3, 300])
        qd, kd, vd = (torch.from_numpy(a).to(dev, torch.bfloat16)
                      for a in (qd, kd, vd))
        lengths = torch.from_numpy(lengths).to(dev)
        (kq, ks), (vq, vs) = (quantize_kv(x) for x in (kd, vd))
        ks, vs = (s.transpose(-1, -2).contiguous() for s in (ks, vs))
        qb, kb, vb = (x.bfloat16() for x in (q, k, v))
        rows = torch.randn((2, 4, 2, 128), device=dev).bfloat16()
        append = (rows[0], rows[1], lengths - 1)
        for fn in (lambda: flash_prefill(qb, kb, vb, seq_lens, window=64),
                   lambda: flash_prefill(q, k, v, seq_lens),
                   lambda: decode_attention(qd, kd, vd, 1, lengths,
                                            window=100),
                   lambda: decode_attention(qd, kq, vq, 0, lengths, ks, vs)):
            fn()  # first use: builds and loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            flash_prefill(qb, kb, vb, seq_lens, window=64)
            flash_prefill(q, k, v, seq_lens)
            decode_attention(qd, kd, vd, 1, lengths, window=100)
            decode_attention(qd, kq, vq, 0, lengths, ks, vs)
            decode_attention(qd, kd, vd, 1, lengths, append=append)
            decode_attention(qd, kq, vq, 0, lengths, ks, vs, append=append)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()

    def test_matmul_wrappers_never_synchronize(self):
        """W8A16 (GEMV, split GEMV, tensor-core) and W8A8 (whole and split
        over K, row quantization included) under the same mode."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(17)
        qt = quantize(torch.randn((4096, 1024), generator=g) * 0.05)
        pt = pack_quantized(qt)
        pq, ps, fq = pt.q.to(dev), pt.scale.to(dev), qt.q.to(dev)
        xs = [torch.randn((m, 4096), generator=g).to(dev, torch.bfloat16)
              for m in (8, 32, 300)]
        calls = ([lambda x=x: w8a16_matmul(x, pq, ps) for x in xs]
                 + [lambda x=x: w8a8_matmul(x, fq, ps) for x in xs])
        for fn in calls:
            fn()  # first use: builds and loads the library
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for fn in calls:
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


@pytest.mark.gpu
class TestKvAppendKernel:
    L, B, T, K, D = 3, 8, 64, 2, 128

    def state(self, dev, dtype, seed=0):
        g = torch.Generator().manual_seed(seed)
        L, B, T, K, D = self.L, self.B, self.T, self.K, self.D
        ck = torch.randint(-127, 128, (L, B, T, K, D), generator=g,
                           dtype=torch.int8)
        cv = torch.randint(-127, 128, (L, B, T, K, D), generator=g,
                           dtype=torch.int8)
        ks = torch.rand((L, B, K, T), generator=g)
        vs = torch.rand((L, B, K, T), generator=g)
        kn = (torch.randn((B, K, D), generator=g) * 3).to(dtype)
        vn = (torch.randn((B, K, D), generator=g) * 3).to(dtype)
        return [t.to(dev) for t in (ck, cv, ks, vs, kn, vn)]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("layer", [0, 2])
    def test_bit_equal_to_plain(self, dtype, layer):
        """Payload AND scales bit-equal: the same float32 arithmetic, rint
        and IEEE division on both sides. Untouched rows survive; an
        out-of-range position writes row T - 1."""
        dev = cuda_or_skip()
        T = self.T
        pos = torch.tensor([0, 1, 31, 32, T - 1, T, T + 5, 40],
                           dtype=torch.int32, device=dev)
        got = self.state(dev, dtype, seed=layer)
        want = self.state(dev, dtype, seed=layer)
        before = kv_append.launches
        kv_append(*got, layer, pos)
        torch.cuda.synchronize()
        assert kv_append.launches == before + 1
        kv_append_reference(*want, layer, pos)
        for g_, w_ in zip(got[:4], want[:4]):
            assert torch.equal(g_, w_)
        pristine = self.state(dev, dtype, seed=layer)
        assert torch.equal(got[0][layer, 7, 41:], pristine[0][layer, 7, 41:])
        assert torch.equal(got[2][layer, 7, :, :40],
                           pristine[2][layer, 7, :, :40])
        other = 1 - layer // 2
        assert torch.equal(got[0][other], pristine[0][other])
        q, _ = quantize_kv(got[4][5:6])
        assert torch.equal(got[0][layer, 5, T - 1], q[0])


@pytest.mark.gpu
class TestFusedAppend:
    """The decode launch's own write of the step's row (append mode)
    against the unfused pair -- the row written first (the standalone
    kv_append kernel for an int8 cache, index assignment otherwise), then
    decode attention -- bit for bit in caches and outputs, and against the
    plain version at the decode tolerance."""

    @pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("G,D", [(4, 128), (7, 128), (16, 128), (4, 96),
                                     (1, 64)])
    @pytest.mark.parametrize("window", [None, 200])
    def test_bit_equal_to_the_unfused_pair(self, kind, G, D, window):
        dev = cuda_or_skip()
        T = 3 * SPAN
        # a span's first and last rows, T - 1, stale past T, past its
        # slot's length (written, not read), the first row
        pos = torch.tensor([SPAN, SPAN - 1, T - 1, T + 40, 500, 0],
                           dtype=torch.int32, device=dev)
        lengths = torch.tensor([SPAN + 1, SPAN, T, T, 300, 1],
                               dtype=torch.int32, device=dev)
        q, k, v, _ = make_case(B=6, T=T, K=2, G=G, D=D, L=2, seed=G + D)
        dtype = torch.float32 if kind == "float32" else torch.bfloat16
        g = torch.Generator().manual_seed(G * D)
        rows = [(torch.randn((6, 2, D), generator=g) * 3).to(dev, dtype)
                for _ in range(2)]
        q = torch.from_numpy(q).to(dev, dtype)
        if kind == "int8":
            (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(a))
                                  for a in (k, v))
            state = [kq, vq, ks.transpose(-1, -2).contiguous(),
                     vs.transpose(-1, -2).contiguous()]
        else:
            state = [torch.from_numpy(a).to(dtype) for a in (k, v)]
            state += [None, None]
        fused, pair, plain = ([t.to(dev) if t is not None else None
                               for t in state] for _ in range(3))
        before = (decode_attention.launches_append, kv_append.launches)
        got = decode_attention(q, fused[0], fused[1], 1, lengths, fused[2],
                               fused[3], window=window,
                               append=(*rows, pos))
        torch.cuda.synchronize()
        assert (decode_attention.launches_append,
                kv_append.launches) == (before[0] + 1, before[1])
        if kind == "int8":
            kv_append(*pair, *rows, 1, pos)
        else:
            b = torch.arange(6, device=dev)
            p = pos.long().clamp(0, T - 1)
            pair[0][1, b, p], pair[1][1, b, p] = rows
        want = decode_attention(q, pair[0], pair[1], 1, lengths, pair[2],
                                pair[3], window=window)
        ref = decode_attention_reference(q, plain[0], plain[1], 1, lengths,
                                         plain[2], plain[3], window=window,
                                         append=(*rows, pos))
        for a, b_, c in zip(fused, pair, plain):
            if a is not None:
                assert torch.equal(a, b_) and torch.equal(a, c)
        assert torch.equal(got, want)
        tol = 1e-4 if kind == "float32" else 2.0 ** -7 * float(
            ref.float().abs().max())
        torch.testing.assert_close(got.float(), ref.float(), atol=tol,
                                   rtol=0)

    def test_refuses_rows_of_another_dtype(self):
        dev = cuda_or_skip()
        q, k, v, lengths = make_case(B=2, T=64, seed=3)
        q, k, v = (torch.from_numpy(a).to(dev, torch.bfloat16)
                   for a in (q, k, v))
        rows = torch.zeros((2, 2, 128), device=dev)
        with pytest.raises(TypeError, match="append"):
            decode_attention(q, k, v, 0, torch.from_numpy(lengths).to(dev),
                             append=(rows, rows, torch.zeros(
                                 2, dtype=torch.int32, device=dev)))


@pytest.mark.gpu
class TestW8A16Kernel:
    # 1..16 rows take the GEMV kernel, more bf16 rows the tensor-core one:
    # rows at and around its 64-row products and 128/256-row tiles
    @pytest.mark.parametrize("M", [1, 8, 16, 17, 64, 127, 128, 129, 255, 256,
                                   300, 2048])
    @pytest.mark.parametrize("K,N", [(64, 64), (128, 192), (4096, 1024),
                                     (1024, 512), (96, 128)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain(self, M, K, N, dtype):
        """Float32 sums on both sides in another order: 1e-4 relative to
        the output's scale in float32; one bf16 rounding of the output
        (2**-8 relative) in bf16."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(M * 7 + K + N)
        x = torch.randn((M, K), generator=g).to(dev, dtype)
        pt = pack_quantized(quantize(torch.randn((K, N), generator=g)
                                     * 0.05))
        q, s = pt.q.to(dev), pt.scale.to(dev)
        regime = w8a16_regime(M, dtype)
        counters = ("launches", "launches_gemv", "launches_gemv_f32",
                    "launches_tc")
        before = [getattr(w8a16_matmul, c) for c in counters]
        got = w8a16_matmul(x, q, s)
        torch.cuda.synchronize()
        assert [getattr(w8a16_matmul, c) - b
                for c, b in zip(counters, before)] == [
            1] + [int(c == f"launches_{regime}") for c in counters[1:]]
        assert got.dtype == dtype and got.shape == (M, N)
        want = w8a16_reference(x, q, s)
        mag = float(want.float().abs().max())
        tol = 1e-4 * mag if dtype == torch.float32 else 8e-3 * mag
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)

    @pytest.mark.parametrize("M", [8, 100, 129, 300, 2048])
    @pytest.mark.parametrize("K,N", [(256, 128), (96, 192)])
    def test_raw_sums_without_scale(self, M, K, N):
        """bf16 rows, float32 raw sums (the LM head's output): products
        exact, float32 sums in another order."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(3)
        x = torch.randn((M, K), generator=g).to(dev, torch.bfloat16)
        pt = pack_quantized(quantize(torch.randn((K, N), generator=g)))
        q, s = pt.q.to(dev), pt.scale.to(dev)
        got = w8a16_matmul(x, q, s, out_dtype=torch.float32,
                           apply_scale=False)
        want = w8a16_reference(x, q, s, out_dtype=torch.float32,
                               apply_scale=False)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-5)

    @pytest.mark.parametrize("M", [17, 300])
    def test_float32_out_scaled(self, M):
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(4)
        x = torch.randn((M, 192), generator=g).to(dev, torch.bfloat16)
        pt = pack_quantized(quantize(torch.randn((192, 320), generator=g)))
        q, s = pt.q.to(dev), pt.scale.to(dev)
        got = w8a16_matmul(x, q, s, out_dtype=torch.float32)
        want = w8a16_reference(x, q, s, out_dtype=torch.float32)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)

    def test_same_rows_twice_bit_equal(self):
        """The tensor-core kernel's sums do not depend on which block or
        tile computed them: two calls agree bit for bit, and so do the
        first 128 rows alone (a 128-row tile) with the same rows inside
        300 (another tile plan)."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(5)
        x = torch.randn((300, 1024), generator=g).to(dev, torch.bfloat16)
        pt = pack_quantized(quantize(torch.randn((1024, 512), generator=g)))
        q, s = pt.q.to(dev), pt.scale.to(dev)
        a, b = w8a16_matmul(x, q, s), w8a16_matmul(x, q, s)
        c = w8a16_matmul(x[:128].contiguous(), q, s)
        torch.cuda.synchronize()
        assert torch.equal(a, b) and torch.equal(a[:128], c)


@pytest.mark.gpu
class TestW8A16Gemv:
    """The GEMV regime at every decode row count: bf16 on the swap-AB
    tensor-core kernel (K split over a cluster: `wk`; not split: the LM
    head), float32 on the FMA kernel."""

    @pytest.fixture(scope="class")
    def leaves(self):
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(23)
        out = {}
        for name, (k, n) in {"wk": (4096, 1024),
                             "lm_head": (4096, 128256)}.items():
            pt = pack_quantized(quantize(torch.randn((k, n), generator=g)
                                         * 0.05))
            out[name] = (pt.q.to(dev), pt.scale.to(dev))
        return out

    @pytest.mark.parametrize("M", range(1, 17))
    @pytest.mark.parametrize("leaf", ["wk", "lm_head"])
    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    def test_every_decode_row_count(self, leaves, M, leaf, dtype):
        """Within 2**-7 max|y| in bf16 (one output rounding), 1e-4 max|y|
        in float32 (summation order only)."""
        dev = cuda_or_skip()
        q, s = leaves[leaf]
        g = torch.Generator().manual_seed(M)
        x = torch.randn((M, q.shape[1]), generator=g).to(dev, dtype)
        counter = f"launches_{w8a16_regime(M, dtype)}"
        before = getattr(w8a16_matmul, counter)
        got = w8a16_matmul(x, q, s)
        torch.cuda.synchronize()
        assert getattr(w8a16_matmul, counter) == before + 1
        want = w8a16_reference(x, q, s)
        mag = float(want.float().abs().max())
        tol = 2.0 ** -7 * mag if dtype == torch.bfloat16 else 1e-4 * mag
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)

    @pytest.mark.parametrize("M", [1, 8, 16])
    @pytest.mark.parametrize("leaf", ["wk", "lm_head"])
    def test_same_call_twice_bit_equal(self, leaves, M, leaf):
        """The cluster sums its splits in rank order: two calls agree bit
        for bit, raw float32 sums included."""
        dev = cuda_or_skip()
        q, s = leaves[leaf]
        g = torch.Generator().manual_seed(40 + M)
        x = torch.randn((M, q.shape[1]), generator=g).to(dev, torch.bfloat16)
        for kw in ({}, {"out_dtype": torch.float32, "apply_scale": False}):
            a, b = w8a16_matmul(x, q, s, **kw), w8a16_matmul(x, q, s, **kw)
            torch.cuda.synchronize()
            assert torch.equal(a, b)

    @pytest.mark.parametrize("M", [1, 9, 16, 17, 40, 300])
    @pytest.mark.parametrize("K,N", [(4096, 1024), (96, 192), (1024, 512)])
    def test_float32_rows_any_count(self, M, K, N):
        """float32 rows on the FMA GEMV at any count, in 16-row tiles past
        16 (a half last step at K = 96): within 1e-5 max|y| of the plain
        version (float32 products, sums in another order), the same bits
        on a second call, no scratch (one launch, nothing allocated but
        the output)."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(M + K + N)
        x = torch.randn((M, K), generator=g).to(dev)
        pt = pack_quantized(quantize(torch.randn((K, N), generator=g)
                                     * 0.05))
        q, s = pt.q.to(dev), pt.scale.to(dev)
        before = w8a16_matmul.launches_gemv_f32
        w8a16_matmul(x, q, s)  # first use: builds, asks the occupancy
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        allocated = torch.cuda.memory_allocated()
        got = w8a16_matmul(x, q, s)
        torch.cuda.synchronize()
        # the peak holds the output (in 512-byte blocks) and nothing else
        assert torch.cuda.max_memory_allocated() - allocated == (
            got.numel() * got.element_size() + 511) // 512 * 512
        assert w8a16_matmul.launches_gemv_f32 == before + 2
        want = w8a16_reference(x, q, s)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
        assert torch.equal(got, w8a16_matmul(x, q, s))

    # Down projections longer than any preset's: Qwen2/2.5-72B and
    # Llama-3.1-405B, at their own widths
    @pytest.mark.parametrize("M", [1, 16])
    @pytest.mark.parametrize("K,N", [(29568, 8192), (53248, 16384)])
    def test_long_k(self, M, K, N):
        """x streams through the ring a step at a time: any K runs on the
        kernel, within 2**-7 max|y|."""
        dev = cuda_or_skip()
        g = torch.Generator(device=dev).manual_seed(K + M)
        pt = pack_quantized(quantize(
            torch.randn((K, N), generator=g, device=dev, dtype=torch.bfloat16)
            .mul_(K ** -0.5)))
        x = torch.randn((M, K), generator=g, device=dev, dtype=torch.bfloat16)
        before = w8a16_matmul.launches_gemv
        got = w8a16_matmul(x, pt.q, pt.scale)
        torch.cuda.synchronize()
        assert w8a16_matmul.launches_gemv == before + 1
        want = w8a16_reference(x, pt.q, pt.scale)
        tol = 2.0 ** -7 * float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)


@pytest.mark.gpu
class TestW8A8Kernel:
    # rows at and around the 64-row products and the 128/256-row tiles;
    # (4096, 1024) and (14336, 256) at few rows are split over K
    @pytest.mark.parametrize("M", [1, 5, 31, 32, 127, 128, 129, 300, 2048])
    @pytest.mark.parametrize("K,N", [(16, 8), (128, 256), (192, 320),
                                     (4096, 1024), (80, 136), (14336, 256)])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_bit_equal_to_plain(self, M, K, N, dtype):
        """Exact int32 sums and the same two rounded multiplies: the
        kernel equals the plain version bit for bit, ragged tiles and K
        splits too."""
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(M * 7 + K + N)
        x = torch.randn((M, K), generator=g).to(dev, dtype)
        qt = quantize(torch.randn((K, N), generator=g) * 0.05)
        q, s = qt.q.to(dev), qt.scale.to(dev)
        before = w8a8_matmul.launches
        got = w8a8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert w8a8_matmul.launches == before + 1
        assert got.dtype == dtype and got.shape == (M, N)
        assert torch.equal(got, w8a8_reference(x, q, s))

    def test_split_shapes_are_split(self):
        """The cases above do cover the K-split path."""
        assert w8a8_plan(32, 4096, 1024)[1] > 1
        assert w8a8_plan(128, 14336, 256)[1] > 1
        assert w8a8_plan(2048, 4096, 1024)[1] == 1

    def test_extreme_values_exact(self):
        """Every product at +-127 x +-127 over the longest preset K: the
        int32 sums stay exact (14336 * 127**2 < 2**31)."""
        dev = cuda_or_skip()
        K, N, M = 14336, 128, 64
        x = torch.full((M, K), 3.0, device=dev)
        x[1::2] = -3.0
        q = torch.full((K, N), 127, dtype=torch.int8, device=dev)
        q[:, 1::2] = -127
        s = torch.ones(N, device=dev)
        got = w8a8_matmul(x, q, s)
        torch.cuda.synchronize()
        assert torch.equal(got, w8a8_reference(x, q, s))

    def test_float32_out_from_bf16_rows(self):
        dev = cuda_or_skip()
        g = torch.Generator().manual_seed(11)
        x = torch.randn((64, 256), generator=g).to(dev, torch.bfloat16)
        qt = quantize(torch.randn((256, 128), generator=g))
        q, s = qt.q.to(dev), qt.scale.to(dev)
        got = w8a8_matmul(x, q, s, out_dtype=torch.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, w8a8_reference(x, q, s,
                                               out_dtype=torch.float32))

    def test_rejects_untileable(self):
        dev = cuda_or_skip()
        qt = quantize(torch.randn((100, 64)))
        with pytest.raises(ValueError):
            w8a8_matmul(torch.randn((8, 100), device=dev), qt.q.to(dev),
                        qt.scale.to(dev))


@pytest.mark.gpu
class TestEngineOnCard:
    @pytest.mark.parametrize("case", ["greedy", "seeded", "head_dim_96"])
    def test_tiny_greedy_card_equals_cpu(self, case):
        """The tiny preset served on the card (kernels) and on the CPU
        (plain versions) from the same float32 weights: greedy ids match,
        seeded sampled ids match (the threefry chains draw the same noise
        on both), and so do greedy ids at head dim 96 (flash and decode run
        it at 128)."""
        import dataclasses

        from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                      SamplingParams)
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
        from symmetry_tpu_torch.models.llama import init_params, preset

        dev = cuda_or_skip()
        cfg = preset("tiny")
        if case == "head_dim_96":
            cfg = dataclasses.replace(cfg, head_dim=96)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32)
        prompts = [[5, 6, 7], list(range(20, 40)), [300] * 9]
        sampling = [SamplingParams(temperature=0.9, top_k=30, seed=s)
                    if case == "seeded" else SamplingParams()
                    for s in range(len(prompts))]

        def run(device):
            engine = InferenceEngine(cfg, params, ByteTokenizer(512),
                                     max_slots=4, max_seq_len=64,
                                     prefill_buckets=(16, 32),
                                     cache_dtype=torch.float32,
                                     decode_block=4, device=device)
            firsts = engine.prefill_and_insert_many(
                [(i, p, sp) for i, (p, sp) in enumerate(zip(prompts,
                                                             sampling))])
            blocks = [np.asarray(engine.decode_steps_dispatch())
                      for _ in range(4)]
            return firsts, np.concatenate(blocks)[:, :len(prompts)]

        f_card, t_card = run(dev)
        f_cpu, t_cpu = run("cpu")
        assert f_card == f_cpu
        np.testing.assert_array_equal(t_card, t_cpu)

    def test_tiny_int8_greedy_card_equals_cpu(self):
        """int8 weights (packed where the kernel takes them) and an int8
        KV cache: W8A16 and the int8 decode kernel, which writes the
        step's row (no standalone KV append), on the card, plain versions
        on the CPU, greedy ids identical."""
        from symmetry_tpu_torch.engine.engine import (InferenceEngine,
                                                      SamplingParams)
        from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
        from symmetry_tpu_torch.models.llama import init_params, preset

        dev = cuda_or_skip()
        cfg = preset("tiny")
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             torch.float32, quantize=True)
        prompts = [[5, 6, 7], list(range(20, 40)), [300] * 9]

        def run(device):
            engine = InferenceEngine(cfg, params, ByteTokenizer(512),
                                     max_slots=4, max_seq_len=64,
                                     prefill_buckets=(16, 32),
                                     cache_dtype=torch.float32,
                                     decode_block=4, kv_quant=True,
                                     fused_dequant=True, device=device)
            firsts = engine.prefill_and_insert_many(
                [(i, p, SamplingParams()) for i, p in enumerate(prompts)])
            blocks = [np.asarray(engine.decode_steps_dispatch())
                      for _ in range(4)]
            return firsts, np.concatenate(blocks)[:, :len(prompts)]

        counts = (w8a16_matmul.launches, decode_attention.launches_append,
                  decode_attention.launches)
        appends = kv_append.launches
        f_card, t_card = run(dev)
        assert all(after > before for after, before in zip(
            (w8a16_matmul.launches, decode_attention.launches_append,
             decode_attention.launches), counts))
        # the decode step's row is written by the decode launch itself
        assert kv_append.launches == appends
        f_cpu, t_cpu = run("cpu")
        assert f_card == f_cpu
        np.testing.assert_array_equal(t_card, t_cpu)
