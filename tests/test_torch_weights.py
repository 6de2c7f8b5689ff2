"""Checkpoint loading in the PyTorch port against the JAX package.

The port reads and writes safetensors with no package (engine/
safetensors_io.py) and loads HF checkpoints onto one device
(engine/weights.py). Here, on the CPU:

- the reader against `safetensors.safe_open` for each dtype, in single
  files and sharded directories; `safe_open` reads the port's writer
  bit-equal;
- `config_from_hf` equals the JAX one on llama, qwen2, gemma, mistral and
  mixtral dicts;
- `convert_hf_state_dict` and `load_checkpoint` (float32 and bf16) give
  trees bit-equal to the JAX functions' on `transformers`-authored tiny
  llama, qwen2 and gemma checkpoints, and int8 quantize-on-load is
  bit-equal too;
- logits within 1e-4 of `transformers` (float32, as test_torch_model.py);
  greedy Scheduler tokens equal the JAX engine's on the same directory;
- `save_checkpoint` round-trips and the JAX loader reads it;
- the warm cache (as tests/test_warm_cache.py): round trips, fallbacks, a
  stale fingerprint, and each package reading the other's cache;
- `from_tpu_config(checkpoint_path=..., device="cpu")` serves, cold then
  warm.
"""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.engine import weights as jax_weights
from symmetry_tpu.engine.engine import InferenceEngine as JaxEngine
from symmetry_tpu.engine.engine import SamplingParams as JaxSampling
from symmetry_tpu.engine.scheduler import GenRequest as JaxRequest
from symmetry_tpu.engine.scheduler import Scheduler as JaxScheduler
from symmetry_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from symmetry_tpu.models import llama as jax_llama
from symmetry_tpu.ops.quant import QuantizedTensor as JaxQuantized
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.engine.engine import (
    InferenceEngine,
    SamplingParams,
)
from symmetry_tpu_torch.engine.safetensors_io import (
    CheckpointError,
    SafetensorsDir,
    SafetensorsFile,
    save_file,
    save_sharded,
)
from symmetry_tpu_torch.engine.scheduler import GenRequest, Scheduler
from symmetry_tpu_torch.engine.tokenizer import ByteTokenizer
from symmetry_tpu_torch.models import llama
from symmetry_tpu_torch.ops.quant import QuantizedTensor
from symmetry_tpu_torch.provider.config import TpuConfig

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")
from safetensors import safe_open  # noqa: E402

ID_BASE = 0x4E00
ATOL = 1e-4


# ---------------------------------------------------------------------------
# Fixtures: tiny transformers-authored checkpoints


def _hf_model(family: str):
    common = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, max_position_embeddings=128,
                  rope_theta=10000.0)
    if family == "llama":
        cfg = transformers.LlamaConfig(**common, rms_norm_eps=1e-5,
                                       tie_word_embeddings=False,
                                       attention_bias=False)
        cls, seed = transformers.LlamaForCausalLM, 7
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(**common, rms_norm_eps=1e-6,
                                       tie_word_embeddings=False,
                                       use_sliding_window=False)
        cls, seed = transformers.Qwen2ForCausalLM, 8
    else:
        cfg = transformers.GemmaConfig(**common, head_dim=16,
                                       rms_norm_eps=1e-6,
                                       tie_word_embeddings=True,
                                       hidden_activation="gelu_pytorch_tanh")
        cls, seed = transformers.GemmaForCausalLM, 11
    torch.manual_seed(seed)
    model = cls(cfg)
    if family == "qwen2":
        # HF initializes biases to zero; nonzero ones make the load visible
        with torch.no_grad():
            for layer in model.model.layers:
                for proj in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                             layer.self_attn.v_proj):
                    proj.bias.normal_(0.0, 0.1)
    model.eval()
    return model


FAMILIES = ("llama", "qwen2", "gemma")


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """family -> (dir, transformers model): float32 safetensors written by
    save_pretrained."""
    out = {}
    for family in FAMILIES:
        path = tmp_path_factory.mktemp(f"hf_{family}")
        model = _hf_model(family)
        model.save_pretrained(path, safe_serialization=True)
        out[family] = (str(path), model)
    return out


@pytest.fixture(scope="module")
def bf16_checkpoint(tmp_path_factory, checkpoints):
    """The llama checkpoint in bf16, sharded by save_pretrained (index
    json + several files)."""
    path = tmp_path_factory.mktemp("hf_llama_bf16")
    model = _hf_model("llama").to(torch.bfloat16)
    model.save_pretrained(path, safe_serialization=True,
                          max_shard_size="60KB")
    return str(path)


def _np(t) -> np.ndarray:
    """A leaf as numpy, bf16 as its uint16 bits (bit-exact comparison)."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        return (t.view(torch.uint16) if t.dtype == torch.bfloat16
                else t).numpy()
    arr = np.asarray(t)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def assert_trees_equal(port: dict, ref: dict) -> None:
    """Bit-equal leaves under the same keys; int8 leaves as (q, scale)."""
    assert set(port) == set(ref)
    for key, value in ref.items():
        got = port[key]
        if isinstance(value, dict):
            assert_trees_equal(got, value)
        elif isinstance(value, JaxQuantized):
            assert isinstance(got, QuantizedTensor), key
            for a, b in ((got.q, value.q), (got.scale, value.scale)):
                np.testing.assert_array_equal(_np(a), _np(b), err_msg=key)
                assert _np(a).dtype == _np(b).dtype, key
        else:
            a, b = _np(got), _np(value)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            np.testing.assert_array_equal(a, b, err_msg=key)


# ---------------------------------------------------------------------------
# The safetensors format


DTYPE_CASES = {"F32": torch.float32, "F16": torch.float16,
               "BF16": torch.bfloat16, "I8": torch.int8, "I32": torch.int32,
               "U16": torch.uint16}


def _tensors(dtype: torch.dtype, seed: int) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    out = {}
    for i, shape in enumerate([(3, 5), (7,), (2, 3, 4), (1,), (0, 4)]):
        if dtype.is_floating_point:
            t = torch.randn(shape, generator=g).to(dtype)
        else:
            t = torch.randint(0, 100, shape, generator=g).to(dtype)
        out[f"t{i}.weight"] = t
    # an odd-sized int8 tensor shifts the later offsets off alignment
    out["a.odd"] = torch.arange(5, dtype=torch.int8)
    return out


class TestSafetensors:
    @pytest.mark.parametrize("code", list(DTYPE_CASES))
    def test_reader_matches_safe_open(self, tmp_path, code):
        from safetensors.torch import save_file as st_save

        tensors = _tensors(DTYPE_CASES[code], 1)
        path = str(tmp_path / "x.safetensors")
        st_save(tensors, path, metadata={"format": "pt"})
        f = SafetensorsFile(path)
        assert f.keys() == sorted(tensors)
        with safe_open(path, framework="pt") as ref:
            for name in tensors:
                want = ref.get_tensor(name)
                got = f.get(name)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(_np(got), _np(want))

    @pytest.mark.parametrize("code", list(DTYPE_CASES))
    def test_safe_open_reads_the_writer(self, tmp_path, code):
        tensors = _tensors(DTYPE_CASES[code], 2)
        path = str(tmp_path / "y.safetensors")
        save_file(tensors, path)
        with open(path, "rb") as fh:
            n = int.from_bytes(fh.read(8), "little")
        assert n % 8 == 0
        with safe_open(path, framework="pt") as ref:
            assert sorted(ref.keys()) == sorted(tensors)
            for name, t in tensors.items():
                got = ref.get_tensor(name)
                assert got.dtype == t.dtype
                np.testing.assert_array_equal(_np(got), _np(t))

    def test_sharded_directories(self, tmp_path, bf16_checkpoint):
        """A save_pretrained sharded dir reads through the index; the
        port's sharded writer reads back through safe_open and the
        port's own reader."""
        index = json.load(open(os.path.join(
            bf16_checkpoint, "model.safetensors.index.json")))
        assert len(set(index["weight_map"].values())) > 1
        store = SafetensorsDir(bf16_checkpoint)
        assert sorted(store.names()) == sorted(index["weight_map"])
        for name, fname in index["weight_map"].items():
            with safe_open(os.path.join(bf16_checkpoint, fname),
                           framework="pt") as ref:
                np.testing.assert_array_equal(_np(store.get(name)),
                                              _np(ref.get_tensor(name)))
        tensors = _tensors(torch.bfloat16, 3)
        out = str(tmp_path / "sharded")
        save_sharded(tensors, out, 3)
        index = json.load(open(os.path.join(
            out, "model.safetensors.index.json")))
        assert sorted(index["weight_map"]) == sorted(tensors)
        assert len(set(index["weight_map"].values())) == 3
        mine = SafetensorsDir(out)
        for name, fname in index["weight_map"].items():
            with safe_open(os.path.join(out, fname), framework="pt") as ref:
                np.testing.assert_array_equal(_np(ref.get_tensor(name)),
                                              _np(tensors[name]))
            np.testing.assert_array_equal(_np(mine.get(name)),
                                          _np(tensors[name]))

    def test_single_file_directory(self, checkpoints):
        path, model = checkpoints["llama"]
        store = SafetensorsDir(path)
        state = model.state_dict()
        assert sorted(store.names()) == sorted(state)
        for name, t in state.items():
            np.testing.assert_array_equal(_np(store.get(name)), _np(t))

    def test_refusals(self, tmp_path):
        from safetensors.torch import save_file as st_save

        path = str(tmp_path / "f64.safetensors")
        st_save({"x": torch.zeros(3, dtype=torch.float64)}, path)
        with pytest.raises(CheckpointError, match="F64"):
            SafetensorsFile(path)
        good = str(tmp_path / "good.safetensors")
        save_file({"x": torch.ones(64)}, good)
        data = open(good, "rb").read()
        cut = str(tmp_path / "cut.safetensors")
        open(cut, "wb").write(data[:-4])
        with pytest.raises(CheckpointError, match="truncated"):
            SafetensorsFile(cut)
        open(cut, "wb").write(b"\xff" * 16)
        with pytest.raises(CheckpointError):
            SafetensorsFile(cut)
        empty = tmp_path / "empty"
        empty.mkdir()
        with pytest.raises(CheckpointError, match="no .safetensors"):
            SafetensorsDir(str(empty))
        with pytest.raises(CheckpointError, match="cannot list"):
            SafetensorsDir(str(tmp_path / "missing"))


# ---------------------------------------------------------------------------
# config_from_hf


HF_DICTS = {
    "llama": {"architectures": ["LlamaForCausalLM"], "vocab_size": 128256,
              "hidden_size": 4096, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 8,
              "intermediate_size": 14336, "rope_theta": 500000.0,
              "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
              "max_position_embeddings": 8192},
    "qwen2": {"architectures": ["Qwen2ForCausalLM"], "vocab_size": 152064,
              "hidden_size": 3584, "num_hidden_layers": 28,
              "num_attention_heads": 28, "num_key_value_heads": 4,
              "intermediate_size": 18944, "rope_theta": 1000000.0,
              "rms_norm_eps": 1e-6, "sliding_window": 131072,
              "use_sliding_window": False},
    "gemma": {"architectures": ["GemmaForCausalLM"], "vocab_size": 256000,
              "hidden_size": 2048, "num_hidden_layers": 18,
              "num_attention_heads": 8, "num_key_value_heads": 1,
              "head_dim": 256, "intermediate_size": 16384,
              "rms_norm_eps": 1e-6},
    "mistral": {"architectures": ["MistralForCausalLM"], "vocab_size": 32000,
                "hidden_size": 4096, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "intermediate_size": 14336, "sliding_window": 4096,
                "rope_theta": 10000.0},
}


class TestConfigFromHF:
    @pytest.mark.parametrize("family", list(HF_DICTS))
    def test_equals_the_jax_config(self, family):
        port = llama.config_from_hf(HF_DICTS[family])
        ref = jax_llama.config_from_hf(HF_DICTS[family])
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert [f.name for f in dataclasses.fields(port)] == [
            f.name for f in dataclasses.fields(ref)]

    def test_field_flags(self):
        qwen = llama.config_from_hf(HF_DICTS["qwen2"])
        assert qwen.attention_bias and qwen.sliding_window is None
        gemma = llama.config_from_hf(HF_DICTS["gemma"])
        assert gemma.norm_plus_one and gemma.scale_embed
        assert gemma.tie_embeddings and gemma.hidden_act == "gelu_tanh"
        assert llama.config_from_hf(HF_DICTS["mistral"]).sliding_window == 4096

    def test_mixtral_raises_item_13(self):
        """Once a refusal (item 13, MoE); now a mixtral dict gives the JAX
        package's MoEConfig, field by field. Gemma2 is still refused."""
        mixtral = dict(HF_DICTS["mistral"], architectures=[
            "MixtralForCausalLM"], num_local_experts=8,
            num_experts_per_tok=2)
        port = llama.config_from_hf(mixtral)
        ref = jax_llama.config_from_hf(mixtral)
        assert type(port).__name__ == type(ref).__name__ == "MoEConfig"
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert [f.name for f in dataclasses.fields(port)] == [
            f.name for f in dataclasses.fields(ref)]
        assert port.num_experts == 8 and port.num_experts_per_tok == 2
        with pytest.raises(ValueError, match="Gemma2"):
            llama.config_from_hf(dict(HF_DICTS["gemma"],
                                      architectures=["Gemma2ForCausalLM"]))

    def test_hf_names(self):
        assert llama.HF_TOP_MAP == jax_llama.HF_TOP_MAP
        assert llama.HF_LAYER_MAP == jax_llama.HF_LAYER_MAP
        assert llama.HF_EXPERT_MAP == jax_llama.HF_EXPERT_MAP
        assert llama.HF_MOE_ROUTER == jax_llama.HF_MOE_ROUTER
        for ours in ("wg", "wu", "wd"):
            assert (llama.hf_expert_name(3, 5, ours)
                    == jax_llama.hf_expert_name(3, 5, ours))


# ---------------------------------------------------------------------------
# Loading against the JAX loader


JAX_DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def jax_load(path, dtype):
    params, config = jax_weights.load_checkpoint(path, dtype=dtype)
    return jax.tree.map(np.asarray, params), config


class TestLoad:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_convert_state_dict(self, checkpoints, family):
        path, model = checkpoints[family]
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        if family == "gemma":  # tied: HF repeats the embedding as the head
            state.pop("lm_head.weight", None)
        cfg = weights.read_hf_config(path)
        jcfg = jax_llama.config_from_hf(json.load(open(
            os.path.join(path, "config.json"))))
        assert_trees_equal(weights.convert_hf_state_dict(state, cfg),
                           jax_weights.convert_hf_state_dict(state, jcfg))

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("family", FAMILIES)
    def test_load_checkpoint_bit_equal(self, checkpoints, family, dtype):
        path, _ = checkpoints[family]
        params, cfg = weights.load_checkpoint(path, dtype=dtype,
                                              device="cpu")
        ref, jcfg = jax_load(path, JAX_DTYPES[dtype])
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert_trees_equal(params, ref)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("family", FAMILIES)
    def test_load_checkpoint_quantized(self, checkpoints, family, dtype,
                                       monkeypatch):
        """quantize=True quantizes each tensor as it is read, in column
        blocks (48 here, so that blocks split every leaf, a partial one
        last): the tree equals the JAX package's quantize_params of its
        dense load, bit for bit."""
        monkeypatch.setattr(weights, "_QUANT_COLS", 48)
        path, _ = checkpoints[family]
        params, _ = weights.load_checkpoint(path, dtype=dtype, device="cpu",
                                            quantize=True)
        ref, _ = jax_weights.load_checkpoint(path, dtype=JAX_DTYPES[dtype])
        assert_trees_equal(params, jax.tree.map(
            np.asarray, jax_llama.quantize_params(ref)))

    def test_bf16_sharded_checkpoint(self, bf16_checkpoint):
        """A bf16 checkpoint read as uint16 and viewed as bf16 (no float32
        on the host), through the sharded index, into f32 and bf16."""
        for dtype in (torch.bfloat16, torch.float32):
            params, _ = weights.load_checkpoint(bf16_checkpoint, dtype=dtype,
                                                device="cpu")
            ref, _ = jax_load(bf16_checkpoint, JAX_DTYPES[dtype])
            assert_trees_equal(params, ref)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_int8_quantize_on_load(self, checkpoints, family):
        path, _ = checkpoints[family]
        params, _ = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                            device="cpu")
        jparams, _ = jax_weights.load_checkpoint(path, dtype=jnp.bfloat16)
        ref = jax.tree.map(np.asarray, jax_llama.quantize_params(jparams))
        assert_trees_equal(llama.quantize_params(params), ref)

    @pytest.mark.parametrize("family", FAMILIES)
    def test_logits_match_transformers(self, checkpoints, family):
        path, model = checkpoints[family]
        params, cfg = weights.load_checkpoint(path, dtype=torch.float32,
                                              device="cpu")
        ids = torch.tensor([[3, 17, 91, 200, 5, 44, 8, 120, 7, 63]])
        with torch.no_grad():
            want = model(ids).logits
        cache = llama.init_cache(cfg, 1, 32, torch.float32, device="cpu")
        got, _ = llama.forward(params, cfg, ids, cache)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)

    def test_refusals(self, checkpoints, tmp_path):
        path, _ = checkpoints["llama"]
        with pytest.raises(CheckpointError, match="no config.json"):
            weights.load_checkpoint(str(tmp_path), device="cpu")
        cfg = weights.read_hf_config(path)
        # MoE loads on a mesh (tests/test_torch_ep.py): a dense checkpoint
        # read sharded under an MoE config lacks the router
        from symmetry_tpu_torch.parallel.mesh import Mesh, MeshSpec

        with pytest.raises(CheckpointError, match="block_sparse_moe.gate"):
            weights.load_checkpoint(path, llama.MoEConfig(
                **dataclasses.asdict(cfg), num_experts=4),
                mesh=Mesh(MeshSpec(model=2)), device="cpu")
        with pytest.raises(CheckpointError, match="shape"):
            weights.load_checkpoint(path, dataclasses.replace(
                cfg, intermediate_size=96), device="cpu")
        # a dense checkpoint read under a mixtral config of its widths
        # lacks the router
        mixtral = llama.MoEConfig(**dataclasses.asdict(cfg), num_experts=4,
                                  num_experts_per_tok=2)
        with pytest.raises(CheckpointError, match="block_sparse_moe.gate"):
            weights.load_checkpoint(path, mixtral, device="cpu")
        # a checkpoint without a head cannot serve an untied config
        gemma_path, _ = checkpoints["gemma"]
        gemma = weights.read_hf_config(gemma_path)
        if "lm_head.weight" not in SafetensorsDir(gemma_path).names():
            with pytest.raises(CheckpointError, match="ties"):
                weights.load_checkpoint(gemma_path, dataclasses.replace(
                    gemma, tie_embeddings=False), device="cpu")
        with pytest.raises(CheckpointError, match="not in checkpoint"):
            weights.load_checkpoint(path, dataclasses.replace(
                cfg, num_layers=3), device="cpu")


class TestSaveCheckpoint:
    def test_round_trip_and_jax_reads_it(self, checkpoints, tmp_path):
        path, _ = checkpoints["qwen2"]
        params, cfg = weights.load_checkpoint(path, dtype=torch.float32,
                                              device="cpu")
        out = str(tmp_path / "saved")
        weights.save_checkpoint(out, params, cfg)
        assert os.path.exists(os.path.join(out, "model.safetensors"))
        again, cfg2 = weights.load_checkpoint(out, dtype=torch.float32,
                                              device="cpu")
        assert cfg2 == cfg
        assert_trees_equal(again, {k: v for k, v in params.items()})
        ref, jcfg = jax_load(out, jnp.float32)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
        assert_trees_equal(params, ref)
        # the same config.json as the JAX writer's
        jax_out = str(tmp_path / "jax_saved")
        jax_weights.save_checkpoint(jax_out, jax_weights.load_checkpoint(
            path, dtype=jnp.float32)[0], jcfg)
        assert (json.load(open(os.path.join(out, "config.json")))
                == json.load(open(os.path.join(jax_out, "config.json"))))

    def test_bf16_sharded_round_trip(self, checkpoints, tmp_path):
        path, _ = checkpoints["gemma"]
        params, cfg = weights.load_checkpoint(path, dtype=torch.bfloat16,
                                              device="cpu")
        out = str(tmp_path / "bf16")
        weights.save_checkpoint(out, params, cfg, dtype=torch.bfloat16,
                                shards=2)
        assert os.path.exists(os.path.join(
            out, "model-00002-of-00002.safetensors"))
        again, _ = weights.load_checkpoint(out, dtype=torch.bfloat16,
                                           device="cpu")
        assert_trees_equal(again, params)
        ref, _ = jax_load(out, jnp.bfloat16)
        assert_trees_equal(params, ref)


# ---------------------------------------------------------------------------
# Serving a loaded checkpoint


class JaxIdTokenizer(JaxByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


class IdTokenizer(ByteTokenizer):
    def decode(self, ids):
        return "".join(chr(ID_BASE + i) for i in ids
                       if i not in (self.BOS, self.EOS))


def serve(scheduler, request_cls, sampling_cls, prompts, max_new):
    events = {i: [] for i in range(len(prompts))}
    done = {i: threading.Event() for i in range(len(prompts))}
    for i, ids in enumerate(prompts):
        def emit(ev, i=i):
            events[i].append(ev)
            if ev.done:
                done[i].set()
        scheduler.submit(request_cls(prompt_ids=list(ids),
                                     sampling=sampling_cls(),
                                     max_new_tokens=max_new, emit=emit,
                                     id=f"r{i}"))
    scheduler.start()
    try:
        for ev in done.values():
            assert ev.wait(120), "request did not complete"
    finally:
        scheduler.stop()
    return [([ord(c) - ID_BASE for c in "".join(e.text for e in events[i])],
             events[i][-1].finish_reason) for i in range(len(prompts))]


PROMPTS = [[3, 17, 91, 200, 5], list(range(40, 54)), list(range(100, 127))]


class TestServe:
    @pytest.mark.parametrize("family", FAMILIES)
    def test_greedy_tokens_equal_the_jax_engine(self, checkpoints, family):
        path, _ = checkpoints[family]
        kw = dict(max_slots=2, max_seq_len=64, prefill_buckets=(16, 32),
                  decode_block=2, prefill_chunk=None)
        jparams, jcfg = jax_weights.load_checkpoint(path, dtype=jnp.float32)
        want = serve(JaxScheduler(JaxEngine(
            jcfg, jparams, JaxIdTokenizer(256), cache_dtype=jnp.float32,
            **kw), debug_invariants=True), JaxRequest, JaxSampling,
            PROMPTS, 10)
        params, cfg = weights.load_checkpoint(path, dtype=torch.float32,
                                              device="cpu")
        got = serve(Scheduler(InferenceEngine(
            cfg, params, IdTokenizer(256), cache_dtype=torch.float32,
            device="cpu", **kw), debug_invariants=True), GenRequest,
            SamplingParams, PROMPTS, 10)
        assert got == want
        assert all(len(ids) >= 1 for ids, _ in got)

    def test_from_tpu_config_cold_then_warm(self, checkpoints, tmp_path,
                                            caplog):
        """A copy of the llama checkpoint: the first engine loads cold and
        writes the warm cache, the second loads from it; both stream the
        same greedy tokens, which equal an engine built from the loaded
        tensors."""
        import shutil

        src, _ = checkpoints["llama"]
        path = str(tmp_path / "ckpt")
        shutil.copytree(src, path)
        raw = {"checkpoint_path": path, "dtype": "float32",
               "max_batch_size": 2, "max_seq_len": 64,
               "prefill_buckets": [16], "decode_block": 1}

        def tokens(engine):
            out = [engine.prefill_and_insert(0, PROMPTS[0],
                                             SamplingParams())]
            out += [int(engine.decode_step()[0]) for _ in range(4)]
            return out

        e1 = InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                             device="cpu")
        assert os.path.exists(weights._warm_path(path, torch.float32,
                                                 False))
        e2 = InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                             device="cpu")
        assert e1.config == e2.config == weights.read_hf_config(path)
        params, cfg = weights.load_checkpoint(path, dtype=torch.float32,
                                              device="cpu")
        ref = InferenceEngine(cfg, params, ByteTokenizer(), max_slots=2,
                              max_seq_len=64, prefill_buckets=(16,),
                              cache_dtype=torch.float32, device="cpu")
        assert tokens(e1) == tokens(e2) == tokens(ref)

    def test_from_tpu_config_int8(self, checkpoints, tmp_path):
        """quantization: int8 quantizes on the cold load and caches the
        int8 tree; fused_dequant packs it."""
        import shutil

        src, _ = checkpoints["qwen2"]
        path = str(tmp_path / "ckpt")
        shutil.copytree(src, path)
        raw = {"checkpoint_path": path, "dtype": "float32",
               "quantization": "int8", "kv_quantization": "int8",
               "fused_dequant": True, "max_batch_size": 2,
               "max_seq_len": 64, "prefill_buckets": [16]}
        engines = [InferenceEngine.from_tpu_config(TpuConfig.from_dict(raw),
                                                   device="cpu")
                   for _ in range(2)]
        warm = weights.load_warm_cache(path, dtype=torch.float32,
                                       quantize=True, device="cpu")
        assert warm is not None
        assert isinstance(warm[0]["layers"]["wq"], QuantizedTensor)
        toks = [e.prefill_and_insert(0, PROMPTS[1], SamplingParams())
                for e in engines]
        assert toks[0] == toks[1]

    def test_missing_checkpoint_raises(self):
        with pytest.raises(CheckpointError, match="/nonexistent/ckpt"):
            InferenceEngine.from_tpu_config(TpuConfig.from_dict(
                {"checkpoint_path": "/nonexistent/ckpt"}), device="cpu")


# ---------------------------------------------------------------------------
# The warm cache


@pytest.fixture
def tiny_checkpoint(tmp_path):
    """A fresh `tiny` checkpoint (float32, the port's writer) per test: the
    warm cache lives inside it."""
    path = str(tmp_path / "tiny")
    cfg = llama.preset("tiny")
    weights.save_checkpoint(path, llama.init_params(
        cfg, torch.Generator().manual_seed(9), torch.float32), cfg)
    return path


class TestWarmCache:
    def test_roundtrip_dense_bf16(self, tiny_checkpoint):
        params, cfg = weights.load_checkpoint(
            tiny_checkpoint, dtype=torch.bfloat16, device="cpu")
        weights.save_warm_cache(tiny_checkpoint, params, cfg,
                                dtype=torch.bfloat16, quantize=False)
        warm = weights.load_warm_cache(tiny_checkpoint, dtype=torch.bfloat16,
                                       quantize=False, device="cpu")
        assert warm is not None and warm[1] == cfg
        assert_trees_equal(warm[0], params)

    def test_roundtrip_quantized_and_packed(self, tiny_checkpoint):
        params, cfg = weights.load_checkpoint(
            tiny_checkpoint, dtype=torch.bfloat16, device="cpu")
        params = llama.quantize_params(params)
        flat = {**params, "layers": dict(params["layers"])}
        packed = llama.pack_params({**params,
                                    "layers": dict(params["layers"])})
        # a packed tree caches its flat layout
        weights.save_warm_cache(tiny_checkpoint, packed, cfg,
                                dtype=torch.bfloat16, quantize=True)
        wparams, _ = weights.load_warm_cache(
            tiny_checkpoint, dtype=torch.bfloat16, quantize=True,
            device="cpu")
        assert isinstance(wparams["layers"]["wq"], QuantizedTensor)
        assert wparams["layers"]["wq"].q.dtype == torch.int8
        for name, leaf in flat["layers"].items():
            got = wparams["layers"][name]
            if isinstance(leaf, QuantizedTensor):
                assert torch.equal(got.q, leaf.q)
                assert torch.equal(got.scale, leaf.scale)
            else:
                assert torch.equal(got, leaf)

    def test_missing_and_corrupt_fall_back(self, tiny_checkpoint, tmp_path):
        assert weights.load_warm_cache(str(tmp_path), dtype=torch.bfloat16,
                                       quantize=False, device="cpu") is None
        params, cfg = weights.load_checkpoint(
            tiny_checkpoint, dtype=torch.float32, device="cpu")
        weights.save_warm_cache(tiny_checkpoint, params, cfg,
                                dtype=torch.float32, quantize=False)
        out = weights._warm_path(tiny_checkpoint, torch.float32, False)
        st = os.path.join(out, "params.safetensors")
        data = open(st, "rb").read()
        open(st, "wb").write(data[:len(data) // 2])  # truncated
        assert weights.load_warm_cache(tiny_checkpoint, dtype=torch.float32,
                                       quantize=False, device="cpu") is None
        open(os.path.join(out, "meta.json"), "w").write("{broken")
        assert weights.load_warm_cache(tiny_checkpoint, dtype=torch.float32,
                                       quantize=False, device="cpu") is None

    def test_stale_cache_invalidated_on_checkpoint_change(
            self, tiny_checkpoint):
        params, cfg = weights.load_checkpoint(
            tiny_checkpoint, dtype=torch.float32, device="cpu")
        weights.save_warm_cache(tiny_checkpoint, params, cfg,
                                dtype=torch.float32, quantize=False)
        assert weights.load_warm_cache(tiny_checkpoint, dtype=torch.float32,
                                       quantize=False,
                                       device="cpu") is not None
        weights.save_checkpoint(tiny_checkpoint, llama.init_params(
            cfg, torch.Generator().manual_seed(2), torch.float32), cfg)
        st = os.path.join(tiny_checkpoint, "model.safetensors")
        os.utime(st, (1.0, 1.0))
        assert weights.load_warm_cache(tiny_checkpoint, dtype=torch.float32,
                                       quantize=False, device="cpu") is None

    @pytest.mark.parametrize("quantize", [False, True],
                             ids=["dense", "int8"])
    def test_jax_cache_loads_in_the_port(self, tiny_checkpoint, quantize):
        jparams, jcfg = jax_weights.load_checkpoint(tiny_checkpoint,
                                                    dtype=jnp.bfloat16)
        if quantize:
            jparams = jax_llama.quantize_params(jparams)
        jax_weights.save_warm_cache(tiny_checkpoint, jparams, jcfg,
                                    dtype=jnp.bfloat16, quantize=quantize)
        warm = weights.load_warm_cache(tiny_checkpoint, dtype=torch.bfloat16,
                                       quantize=quantize, device="cpu")
        assert warm is not None
        assert dataclasses.asdict(warm[1]) == dataclasses.asdict(jcfg)
        assert_trees_equal(warm[0], jax.tree.map(np.asarray, jparams))

    @pytest.mark.parametrize("quantize", [False, True],
                             ids=["dense", "int8"])
    def test_port_cache_loads_in_jax(self, tiny_checkpoint, quantize):
        params, cfg = weights.load_checkpoint(
            tiny_checkpoint, dtype=torch.bfloat16, device="cpu")
        if quantize:
            params = llama.quantize_params(params)
        weights.save_warm_cache(tiny_checkpoint, params, cfg,
                                dtype=torch.bfloat16, quantize=quantize)
        warm = jax_weights.load_warm_cache(tiny_checkpoint,
                                           dtype=jnp.bfloat16,
                                           quantize=quantize)
        assert warm is not None
        assert dataclasses.asdict(warm[1]) == dataclasses.asdict(cfg)
        assert_trees_equal(params, jax.tree.map(np.asarray, warm[0]))
