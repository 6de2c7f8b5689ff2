"""The port's copies of the JAX package's JAX-free modules stay copies.

Under the copy rule (ROADMAP "The copy rule") a module of `symmetry_tpu`
that computes nothing with JAX is copied into `symmetry_tpu_torch` at the
same relative path with only its imports rewritten: every line that starts
(after indentation) with `from symmetry_tpu` or `import symmetry_tpu`
names `symmetry_tpu_torch` instead. For each copy this test reads the JAX
source, applies that rewrite, and diffs it against the port's source line
by line. Every hunk of the diff must be one of the module's named
deviations in DEVIATIONS below: a hunk matches a deviation when one of its
lines, prefixed "-" (the JAX side) or "+" (the port's), contains one of
the deviation's anchors. Each module's hunk count is pinned, and every
anchor must still match a hunk. So a copy that has gone stale against its
JAX original, or an edit to a copy outside its named deviations, fails
here on the CPU.

Every other module of the port that has a JAX counterpart is a port (it
computes with torch) and is listed in PORTED.
"""

import difflib
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPORT = re.compile(r"^(\s*)(from|import)(\s+)symmetry_tpu(?=[.\s])")

COPIES = [
    # earlier slices
    "engine/scheduler.py", "engine/ledger.py", "engine/tokenizer.py",
    "engine/prefix_cache.py", "engine/spec/__init__.py",
    "engine/spec/drafter.py", "engine/disagg/frames.py", "protocol/keys.py",
    "provider/config.py", "utils/logging.py", "utils/faults.py",
    "utils/metrics.py", "utils/trace.py",
    # the provider, server, client and network stack
    "utils/json.py", "protocol/__init__.py", "protocol/messages.py",
    "protocol/framing.py", "identity/__init__.py", "identity/identity.py",
    "identity/noise.py", "transport/__init__.py", "transport/base.py",
    "transport/memory.py", "transport/tcp.py", "transport/udp.py",
    "network/__init__.py", "network/peer.py", "network/relay.py",
    "network/dht.py", "network/natpunch.py", "server/__init__.py",
    "server/__main__.py", "server/tokens.py", "server/registry.py",
    "server/broker.py", "provider/__init__.py", "provider/__main__.py",
    "provider/provider.py", "provider/collect.py",
    "provider/backends/__init__.py", "provider/backends/base.py",
    "provider/backends/echo.py", "provider/backends/proxy.py",
    "provider/backends/tpu_native.py", "engine/disagg/__init__.py",
    "engine/disagg/broker.py", "engine/disagg/net.py",
    "engine/disagg/pool.py", "engine/disagg/node.py",
    "engine/disagg/autoscale.py", "client/__init__.py",
    "client/__main__.py", "client/client.py",
    # the static-analysis suite, its scopes pointed at the port
    "analysis/__init__.py", "analysis/core.py", "analysis/dataflow.py",
    "analysis/concurrency.py", "analysis/donation.py",
    "analysis/fault_seams.py", "analysis/knobs.py", "analysis/lifecycle.py",
    "analysis/metric_names.py", "analysis/recompile.py",
    "analysis/wire_contract.py",
]

# Modules of the port that compute with torch (or describe the port): not
# copies, held against the JAX package by the parity tests instead.
PORTED = {
    "__init__.py", "engine/__init__.py", "engine/engine.py",
    "engine/host.py", "engine/weights.py", "models/__init__.py",
    "models/llama.py", "models/moe.py", "ops/__init__.py", "ops/attention.py",
    "ops/decode_attention.py", "ops/flash.py", "ops/kv_append.py",
    "ops/norm.py", "ops/qmm.py", "ops/quant.py", "ops/rope.py",
    "ops/sampling.py", "utils/__init__.py", "utils/compile_cache.py",
    "utils/devprof.py", "parallel/__init__.py", "parallel/mesh.py",
    "parallel/sharding.py", "parallel/multihost.py", "parallel/ring.py",
    "parallel/ulysses.py", "parallel/pipeline.py",
    "analysis/__main__.py",
}

# Ports whose counterpart is a script outside the JAX package, not a module
# at the same path: port path -> the script.
TWIN_SCRIPTS = {"analysis/__main__.py": "tools/symlint.py"}

HISTORY = ("history references reworded",
           "the JAX package's comments cite its own PR numbers and a "
           "path on the machine its reference was read from; the copy's "
           "comments say the same without them")

SCOPE = ("scope: the port",
         "the checker's file globs name symmetry_tpu_torch/ where the JAX "
         "package's name symmetry_tpu/ (tools/*.py and tests/** stay in "
         "the scopes that had them)")
MESSAGE = ("messages name the port's files",
           "a finding's message names the port's registry or package, not "
           "the JAX package's")
# recompile-hazard and donation check jax.jit regions; the port has none
# until CUDA graphs give it captured regions (ROADMAP item 18), so over the
# port's tree they find nothing to check. They stay in ALL_CHECKERS so their
# seeded fixtures keep running (tests/test_torch_analysis.py).
NO_JIT = ("scope: the port (no jit regions yet)",
          "the scope points at the port's engine, spec, ops and models; the "
          "port has no jax.jit, so over its tree the checker has no target "
          "until captured regions exist (ROADMAP item 18), and its seeded "
          "fixtures still run")

# module -> (hunks in the diff, [(deviation, why, anchors)]).
DEVIATIONS = {
    "analysis/__init__.py": (6, [
        ("the scan leaves out the JAX package",
         "Project.class_constants and knobs._tpu_fields take the first "
         "scanned file that defines a class; symmetry_tpu/ sorts before "
         "symmetry_tpu_torch/, so a scan of the whole repo would hold the "
         "port against the JAX package's TpuConfig and registries. run() "
         "scans scanned_files(root), every file but symmetry_tpu/**, and "
         "core.py and knobs.py stay line for line",
         ["+    iter_py_files,", "+def scanned_files(root: str)",
          "+    project = Project.scan(root, rels if rels is not None",
          '+           "Project", "run", "run_suite", "scanned_files"]']),
        ("the runner's name",
         "the port's suite runs as python -m symmetry_tpu_torch.analysis "
         "(__main__.py), and tests/test_torch_analysis.py holds the port "
         "clean",
         ["(see __main__.py)",
          "+Run via `python -m symmetry_tpu_torch.analysis`"]),
    ]),
    "analysis/concurrency.py": (1, [
        (*SCOPE, ['+SCOPE = ("symmetry_tpu_torch/**",)']),
    ]),
    "analysis/donation.py": (1, [
        (*NO_JIT, ['+GROUP = ("symmetry_tpu_torch/*.py",)']),
    ]),
    "analysis/recompile.py": (1, [
        (*NO_JIT, ['+    "symmetry_tpu_torch/engine/engine.py",']),
    ]),
    "analysis/fault_seams.py": (2, [
        (*SCOPE, ['+GUARD_SCOPE = ("symmetry_tpu_torch/**",',
                  '+ARM_SCOPE = ("symmetry_tpu_torch/**",']),
    ]),
    "analysis/knobs.py": (2, [
        (*SCOPE, ['+GROUP = ("symmetry_tpu_torch/*.py",)']),
        (*MESSAGE, ['+                    f"symmetry_tpu_torch/ — a dead knob']),
    ]),
    "analysis/lifecycle.py": (1, [
        (*SCOPE, ['+GROUP = ("symmetry_tpu_torch/*.py",)']),
    ]),
    "analysis/metric_names.py": (3, [
        (*SCOPE, ['+EMIT_GROUP = ("symmetry_tpu_torch/*.py",)']),
        (*MESSAGE, ["+                                f'symmetry_tpu_torch/utils/"
                    "metrics.py'))",
                    '("symmetry_tpu_torch/utils/metrics.py", 1))']),
    ]),
    "analysis/wire_contract.py": (6, [
        (*SCOPE, ['+    "symmetry_tpu_torch/engine/host.py",',
                  '+    "symmetry_tpu_torch/engine/disagg/net.py",',
                  '+    "symmetry_tpu_torch/provider/*.py",']),
        (*MESSAGE, ["+                 f'(symmetry_tpu_torch/protocol/keys.py)",
                    "+                    f' from symmetry_tpu_torch/protocol/"
                    "keys.py'))",
                    "+                    f'{registry_class} "
                    "(symmetry_tpu_torch/protocol/keys.py) '"]),
    ]),
    "engine/disagg/autoscale.py": (1, [
        (*HISTORY, ["+Every piece existed before this module and nothing "
                    "connected them: the"]),
    ]),
    "engine/disagg/net.py": (1, [
        (*HISTORY, ["+The local disaggregated prefill/decode pair only"]),
    ]),
    "engine/disagg/pool.py": (4, [
        (*HISTORY, ["+The local pair is ONE prefill",
                    "telemetry feed (the SLO", "+pair's behavior.",
                    "+    backend keeps the pair semantics untouched."]),
    ]),
    "engine/disagg/frames.py": (8, [
        ("bfloat16 without ml_dtypes",
         "numpy has no bfloat16 and the port does not use ml_dtypes: a "
         "bfloat16 payload is read as its uint16 words (BFloat16Array) and "
         "such arrays are written under the wire name bfloat16, so frames "
         "interchange byte for byte",
         ["+Copied from symmetry_tpu/engine/disagg/frames.py",
          "+class BFloat16Array(np.ndarray):",
          '"bfloat16" payloads are read as', "-    import ml_dtypes",
          "+        dtype_b = wire_dtype(arr).encode()",
          "-        dtype_b = arr.dtype.name.encode()",
          '+        dtype_name = take(dtype_len, "dtype name").decode()',
          "+        if dtype_name == BFLOAT16:"]),
    ]),
    "provider/config.py": (3, [
        ("yaml imported where YAML is read and written",
         "the engine host and the tests build configs from dicts; pyyaml is "
         "needed only to read or write a file",
         ["-import yaml", "+            import yaml", "+    import yaml"]),
    ]),
    "utils/trace.py": (5, [
        ("device_trace over torch.profiler",
         "the capture is the card's (CUPTI through torch.profiler, a Chrome "
         "trace file), with a gate held around its start and stop (a stop "
         "racing an engine launch crashes the process)",
         ["torch.profiler capture for the CUDA engine",
          "+def device_trace_activities() -> list:",
          "+def device_trace(log_dir: str, gate: Any = None)",
          "+    gate = gate if gate is not None else contextlib.nullcontext()",
          "-        jax.profiler.stop_trace()"]),
    ]),
    "provider/backends/base.py": (3, [
        (*HISTORY, ["+    # (nothing in the reference's src/provider.ts"]),
        ("get_backend(device=)",
         "the torch device of a tpu_native backend's engine (the provider "
         "CLI's --device)",
         ['+def get_backend(config: Any, *, device: str = "cuda")',
          "+        return TpuNativeBackend(config, device=device)"]),
    ]),
    "provider/backends/proxy.py": (3, [
        ("aiohttp imported in start and stream",
         "the client imports this module's SSE helpers: neither it nor a "
         "tpu_native provider may need aiohttp, which the card's machine "
         "does not have",
         ["-import aiohttp", "+        import aiohttp"]),
    ]),
    "engine/disagg/node.py": (8, [
        ("the port's engine host and its device",
         "PrefillNode spawns python -m symmetry_tpu_torch.engine.host, "
         "with --device when the device is not the card",
         ['+                 device: str = "cuda") -> None:',
          "+        self._device = device",
          '"-m", "symmetry_tpu_torch.engine.host",',
          "+        return (argv if self._device == \"cuda\"",
          "+async def _serve(config_path: str, device: str = \"cuda\")",
          "+    node = PrefillNode(config, device=device)",
          "+    args = sys.argv[1:]",
          "+        _serve(args[0], device))"]),
    ]),
    "engine/disagg/__init__.py": (4, [
        ("the frames' bfloat16 names exported",
         "BFloat16Array and wire_dtype (frames.py's deviation) are part of "
         "the port's frame API since the frames came alone",
         ["+    BFloat16Array,", "+    wire_dtype,", '+    "BFloat16Array",',
          '+    "wire_dtype",']),
    ]),
    "provider/backends/tpu_native.py": (12, [
        (*HISTORY, ["+        \"\"\"Disagg with BOTH tiers as local "
                    "subprocesses (the pair);"]),
        ("the device",
         "TpuNativeBackend(config, device=): the inproc engine's device, "
         "and --device for the engine hosts and prefill nodes it spawns",
         ['+    def __init__(self, config: Any, *, device: str = "cuda")',
          "+        # The torch device of the engine",
          "+            return InferenceEngine.from_tpu_config(tpu_cfg,",
          "+            self._inline_node = PrefillNode(self._config, "
          "listen=peer,",
          "+        return PrefillNode(config, listen=listen, "
          "device=self._device)"]),
        ("_host_argv spawns the port's host",
         "python -m symmetry_tpu_torch.engine.host cfg [--device d]",
         ['"-m", "symmetry_tpu_torch.engine.host",']),
        ("the inproc engine behind GatedEngine",
         "the Scheduler's launches and the inproc capture's profiler start "
         "and stop share one lock (engine/host.py GatedEngine); Kineto "
         "starts on the thread that starts the backend",
         ["+import threading",
          "+        sched_engine = GatedEngine(self._engine, "
          "self._device_gate)",
          "+                self._device_gate)"]),
        ("the command loop through the gate",
         "a multihost rank 0's CommandLoop executes through the same gate "
         "(parallel/multihost.py), which the GatedEngine it replaces held",
         ["+                                             "
          "gate=self._device_gate)"]),
        ("the worker CLI is the port's",
         "other ranks run `python -m symmetry_tpu_torch.provider --worker`",
         ['+                "`python -m symmetry_tpu_torch.provider '
          '--worker`")']),
    ]),
    "provider/__main__.py": (8, [
        ("--device",
         "the engine's torch device, default the card",
         ["+from symmetry_tpu_torch.provider.backends.base import "
          "get_backend",
          '+async def run(config_path: str, device: str = "cuda")',
          '+    parser.add_argument("--device", default="cuda",',
          "+        asyncio.run(run(args.config, args.device))"]),
        ("--worker on the port's engine",
         "the worker rank builds the port's engine on --device and mirrors "
         "rank 0's engine calls (PyTorch runs eagerly: no jitted calls)",
         ["+def run_worker(config_path: str, device: str = \"cuda\")",
          "+    the identical engine and mirror rank 0's engine calls",
          "+    engine = InferenceEngine.from_tpu_config(config.tpu, "
          "device=device)",
          "+        run_worker(args.config, args.device)"]),
    ]),
}


def rewrite_imports(src: str) -> list[str]:
    return [IMPORT.sub(r"\1\2\3symmetry_tpu_torch", line)
            for line in src.splitlines()]


def hunks(module: str) -> list[list[str]]:
    """The diff's hunks, each as its lines prefixed "-" (JAX, imports
    rewritten) or "+" (the port)."""
    with open(os.path.join(REPO, "symmetry_tpu", module)) as fh:
        jax_lines = rewrite_imports(fh.read())
    with open(os.path.join(REPO, "symmetry_tpu_torch", module)) as fh:
        port_lines = fh.read().splitlines()
    sm = difflib.SequenceMatcher(None, jax_lines, port_lines, autojunk=False)
    return [["-" + x for x in jax_lines[i1:i2]]
            + ["+" + x for x in port_lines[j1:j2]]
            for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal"]


@pytest.mark.parametrize("module", COPIES)
def test_copy_equals_its_original(module):
    found = hunks(module)
    n_expected, deviations = DEVIATIONS.get(module, (0, []))
    anchors = [a for _, _, anchs in deviations for a in anchs]

    def matches(hunk, anchor):
        return any(anchor in line for line in hunk)

    unnamed = [h for h in found if not any(matches(h, a) for a in anchors)]
    assert not unnamed, (
        f"{module}: hunks that are no named deviation:\n"
        + "\n---\n".join("\n".join(h) for h in unnamed))
    stale = [a for a in anchors if not any(matches(h, a) for h in found)]
    assert not stale, f"{module}: deviations that match no hunk: {stale}"
    assert len(found) == n_expected, (
        f"{module}: {len(found)} hunks, {n_expected} named")


def test_every_counterpart_is_a_copy_or_a_port():
    """Each module of the port with a same-path module in the JAX package
    is held here as a copy or named as a port; no module is both."""
    port_root = os.path.join(REPO, "symmetry_tpu_torch")
    twins = set()
    for dirpath, _, files in os.walk(port_root):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), port_root)
            if os.path.exists(os.path.join(REPO, "symmetry_tpu", rel)):
                twins.add(rel)
    twins |= {port for port, script in TWIN_SCRIPTS.items()
              if os.path.exists(os.path.join(port_root, port))
              and os.path.exists(os.path.join(REPO, script))}
    assert not set(COPIES) & PORTED
    assert twins == set(COPIES) | PORTED, (
        sorted(twins ^ (set(COPIES) | PORTED)))
    assert set(DEVIATIONS) <= set(COPIES)
