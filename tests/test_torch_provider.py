"""The port's provider stack against the JAX package's, on the CPU.

- Parity: a tiny float32 checkpoint, written by the port's save_checkpoint
  from JAX-initialised params, and a byte-level BPE tokenizer authored
  here, served through `tpu.checkpoint_path` by both stacks: JAX client ->
  JAX server -> JAX provider -> JAX engine (inproc), and the port's client
  -> server -> provider -> engine, inproc, in process isolation (the port's
  host with --device cpu) and as the local disagg pair (a prefill host and
  a decode host under the provider's own broker). Greedy text must be
  identical. (The JAX process and disagg legs are `slow` in the JAX suite,
  tests/test_e2e_tpu_native.py and tests/test_disagg.py, so the JAX inproc
  stream is the reference for all three.)
- The inproc capture holds the engine gate: the Scheduler drives a
  GatedEngine, and capture_profile waits while a dispatch holds the gate.
- Refusals: a data axis across hosts (multihost dcn_data, ROADMAP item
  14) from the backend and from the provider CLI's --worker.
- The card's machine has no JAX, no symmetry_tpu and no aiohttp: the
  server and provider CLIs run as subprocesses with those three made
  unimportable (a sitecustomize on PYTHONPATH, so the provider's engine
  host is held to it too) and serve one chat to the port's client over
  TCP loopback.
"""

import asyncio
import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from symmetry_tpu.models import init_params as jax_init_params
from symmetry_tpu.models import preset as jax_preset
from symmetry_tpu_torch.convert import params_from_numpy
from symmetry_tpu_torch.engine import weights
from symmetry_tpu_torch.models import preset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTENTS = ["hello world", "the quick brown fox and the assistant",
            "symmetry on tpu, user and assistant talk about it"]
MAX_NEW = 8


@pytest.fixture(scope="module")
def served_model(tmp_path_factory):
    """(checkpoint dir, tokenizer dir): tiny float32 weights from JAX's
    init, written in the HF layout by the port; a tokenizers-library
    byte-level BPE with a chat template."""
    import tokenizers

    root = tmp_path_factory.mktemp("served")
    tree = jax.tree.map(np.asarray, jax_init_params(
        jax_preset("tiny"), jax.random.key(0), jnp.float32))
    ckpt = str(root / "ckpt")
    weights.save_checkpoint(ckpt, params_from_numpy(tree, device="cpu"),
                            preset("tiny"))
    tok_dir = root / "tok"
    tok_dir.mkdir()
    tok = tokenizers.Tokenizer(tokenizers.models.BPE(unk_token=None))
    tok.pre_tokenizer = tokenizers.pre_tokenizers.ByteLevel(
        add_prefix_space=False)
    tok.decoder = tokenizers.decoders.ByteLevel()
    trainer = tokenizers.trainers.BpeTrainer(
        vocab_size=384, special_tokens=["<|bos|>", "<|eos|>"],
        initial_alphabet=tokenizers.pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CONTENTS + ["user: ", "assistant: "], trainer)
    tok.save(str(tok_dir / "tokenizer.json"))
    (tok_dir / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "bos_token": "<|bos|>", "eos_token": "<|eos|>",
        "chat_template": (
            "{% for m in messages %}{{ m['role'] }}: {{ m['content'] }}"
            "\n{% endfor %}assistant: ")}))
    return ckpt, str(tok_dir)


def tpu_section(served, **extra):
    ckpt, tok = served
    return {"checkpoint_path": ckpt, "tokenizer_path": tok,
            "dtype": "float32", "max_batch_size": 4, "max_seq_len": 128,
            "prefill_buckets": [32, 64], "prefill_chunk": 16,
            "compile_cache": False, **extra}


def serve_through(pkg: str, tpu: dict, *, device: str | None = None,
                  env_path: bool = False) -> list[str]:
    """CONTENTS through `pkg`'s client -> server -> provider (tpu_native)
    over its MemoryTransport, one chat at a time; greedy texts."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    Identity = mod("identity").Identity
    ConfigManager = mod("provider.config").ConfigManager
    SymmetryServer = mod("server.broker").SymmetryServer
    SymmetryProvider = mod("provider.provider").SymmetryProvider
    SymmetryClient = mod("client.client").SymmetryClient
    MemoryTransport = mod("transport.memory").MemoryTransport

    async def main():
        hub = MemoryTransport()
        server_ident = Identity.from_name(f"{pkg}-parity-server")
        server = SymmetryServer(server_ident, hub, ping_interval_s=30.0)
        await server.start("mem://server")
        cfg = ConfigManager(config={
            "name": "parity-prov", "public": True,
            "serverKey": server_ident.public_hex, "modelName": "tiny:ckpt",
            "apiProvider": "tpu_native", "dataCollectionEnabled": False,
            "tpu": tpu})
        backend = None
        if device is not None:
            backend = mod("provider.backends.base").get_backend(
                cfg, device=device)
        provider = SymmetryProvider(
            cfg, transport=hub, identity=Identity.from_name("parity-prov"),
            backend=backend, server_address="mem://server")
        await provider.start("mem://parity-prov")
        try:
            await provider.wait_registered()
            client = SymmetryClient(Identity.from_name("parity-cli"), hub)
            session = await client.connect(await client.request_provider(
                "mem://server", server_ident.public_key, "tiny:ckpt"))
            try:
                return [await session.chat_text(
                    [{"role": "user", "content": c}], max_tokens=MAX_NEW,
                    temperature=0.0) for c in CONTENTS]
            finally:
                await session.close()
        finally:
            await provider.stop()
            await server.stop()

    return asyncio.new_event_loop().run_until_complete(
        asyncio.wait_for(main(), 300))


@pytest.fixture(scope="module")
def jax_texts(served_model):
    return serve_through("symmetry_tpu",
                         tpu_section(served_model,
                                     engine_isolation="inproc"))


@pytest.fixture
def repo_on_path(monkeypatch):
    """Engine hosts are `python -m symmetry_tpu_torch.engine.host`."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))


@pytest.mark.parametrize("leg", [
    {"engine_isolation": "inproc"},
    {"engine_isolation": "process"},
    {"engine_isolation": "process", "role": "disagg"},
], ids=["inproc", "process", "disagg"])
def test_greedy_text_equals_the_jax_stack(served_model, jax_texts,
                                          repo_on_path, leg):
    got = serve_through("symmetry_tpu_torch",
                        tpu_section(served_model, **leg), device="cpu")
    assert got == jax_texts
    assert all(jax_texts)


def test_inproc_capture_waits_for_the_engine_gate(served_model,
                                                  tmp_path):
    """engine_isolation: inproc runs the Scheduler over a GatedEngine that
    shares the backend's gate, and capture_profile's profiler start waits
    while a dispatch holds that gate (tests/test_torch_host.py pins the
    same for the host)."""
    from symmetry_tpu_torch.engine.host import GatedEngine
    from symmetry_tpu_torch.provider.backends.base import InferenceRequest
    from symmetry_tpu_torch.provider.backends.tpu_native import (
        TpuNativeBackend)
    from symmetry_tpu_torch.provider.config import ConfigManager

    cfg = ConfigManager(config={
        "name": "gate", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny:ckpt", "apiProvider": "tpu_native",
        "tpu": tpu_section(served_model, engine_isolation="inproc")})

    async def main():
        backend = TpuNativeBackend(cfg, device="cpu")
        await backend.start()
        try:
            sched_engine = backend._scheduler.engine
            assert isinstance(sched_engine, GatedEngine)
            assert sched_engine._gate is backend._device_gate
            held, release = threading.Event(), threading.Event()

            def dispatch():
                with backend._device_gate:
                    held.set()
                    release.wait(30)

            t = threading.Thread(target=dispatch)
            t.start()
            assert held.wait(5)
            capture = asyncio.ensure_future(backend.capture_profile(
                duration_s=0.05, out_dir=str(tmp_path)))
            await asyncio.sleep(0.5)
            assert not capture.done()
            release.set()
            out = await asyncio.wait_for(capture, 60)
            t.join(5)
            assert not t.is_alive()
            assert out.get("error") is None, out
            assert os.path.isdir(out["path"])
            # the engine serves on after the capture
            text = []
            async for chunk in backend.stream(InferenceRequest(
                    messages=[{"role": "user", "content": CONTENTS[0]}],
                    max_tokens=4, temperature=0.0)):
                text.append(chunk.text)
            assert "".join(text)
        finally:
            await backend.stop()

    asyncio.new_event_loop().run_until_complete(asyncio.wait_for(main(),
                                                                 120))


def test_multihost_refused_with_item_14(tmp_path):
    from symmetry_tpu_torch.engine.engine import EngineError
    from symmetry_tpu_torch.provider.backends.tpu_native import (
        TpuNativeBackend)
    from symmetry_tpu_torch.provider.config import ConfigManager

    cfg = ConfigManager(config={
        "name": "mh", "public": False, "serverKey": "00" * 32,
        "modelName": "tiny", "apiProvider": "tpu_native",
        "tpu": {"model_preset": "tiny", "dtype": "float32",
                "engine_isolation": "inproc", "compile_cache": False,
                "multihost": {"coordinator": "127.0.0.1:1",
                              "num_processes": 2, "process_id": 0,
                              "dcn_data": 2}}})
    backend = TpuNativeBackend(cfg, device="cpu")
    with pytest.raises(EngineError, match="item 14"):
        asyncio.new_event_loop().run_until_complete(backend.start())

    # a worker rank of the same job (multihost serving itself:
    # tests/test_torch_tp.py)
    worker = cfg.get_all()
    worker["tpu"]["multihost"]["process_id"] = 1
    path = tmp_path / "p.json"
    path.write_text(json.dumps(worker))
    proc = subprocess.run(
        [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c",
         str(path), "--worker", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert proc.returncode != 0
    assert "ROADMAP Queue 1 item 14" in proc.stderr


# ---------------------------------------------------------------------------
# The card machine's situation: no jax, no symmetry_tpu, no aiohttp

BLOCKER = '''
import sys


class _Unimportable:
    """jax, symmetry_tpu and aiohttp are absent on the card's machine."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "symmetry_tpu",
                                  "aiohttp"):
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Unimportable())
'''


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_clis_serve_a_chat_without_jax(tmp_path):
    from symmetry_tpu_torch.client.client import SymmetryClient
    from symmetry_tpu_torch.identity import Identity
    from symmetry_tpu_torch.transport.tcp import TcpTransport

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(BLOCKER)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(site), REPO]),
           "HOME": str(tmp_path)}
    check = subprocess.run(
        [sys.executable, "-c", "import jax"], env=env, capture_output=True,
        text=True, timeout=60)
    assert check.returncode != 0 and "blocked" in check.stderr

    port = free_port()
    procs = []
    try:
        server = subprocess.Popen(
            [sys.executable, "-m", "symmetry_tpu_torch.server", "--host",
             "127.0.0.1", "--port", str(port), "--db", ":memory:",
             "--punch-port", "-1", "--seed-name", "cli-server"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        procs.append(server)
        key = None
        deadline = time.monotonic() + 120
        while key is None and time.monotonic() < deadline:
            line = server.stdout.readline()
            assert line, "server exited before printing its key"
            if line.startswith("serverKey: "):
                key = line.split()[-1]
        assert key is not None
        cfg = {"name": "cli-prov", "public": True, "serverKey": key,
               "serverAddress": f"tcp://127.0.0.1:{port}",
               "listenHost": "127.0.0.1", "modelName": "tiny:cli",
               "apiProvider": "tpu_native", "dataCollectionEnabled": False,
               "path": str(tmp_path / "state"),
               "tpu": {"model_preset": "tiny", "dtype": "float32",
                       "max_batch_size": 2, "max_seq_len": 128,
                       "prefill_buckets": [32, 64],
                       "compile_cache": False}}
        cfg_path = tmp_path / "provider.yaml"
        cfg_path.write_text(json.dumps(cfg))
        log_path = tmp_path / "provider.log"
        with open(log_path, "w") as log:
            provider = subprocess.Popen(
                [sys.executable, "-m", "symmetry_tpu_torch.provider", "-c",
                 str(cfg_path), "--device", "cpu"], cwd=str(tmp_path),
                env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append(provider)
        deadline = time.monotonic() + 180
        while "registered with server" not in log_path.read_text():
            assert provider.poll() is None, log_path.read_text()
            assert time.monotonic() < deadline, log_path.read_text()
            time.sleep(0.2)

        async def chat():
            client = SymmetryClient(Identity.from_name("cli-client"),
                                    TcpTransport())
            details = await client.request_provider(
                f"tcp://127.0.0.1:{port}", bytes.fromhex(key), "tiny:cli")
            session = await client.connect(details)
            try:
                return await session.chat_text(
                    [{"role": "user", "content": "hello"}], max_tokens=8,
                    temperature=0.0)
            finally:
                await session.close()

        text = asyncio.new_event_loop().run_until_complete(
            asyncio.wait_for(chat(), 120))
        assert text
        provider.terminate()
        assert provider.wait(60) == 0
        log = log_path.read_text()
        assert "engine host ready" in log and "device=cpu" in log
        assert "blocked" not in log and "Traceback" not in log
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(30)
        if procs:
            procs[0].stdout.close()
