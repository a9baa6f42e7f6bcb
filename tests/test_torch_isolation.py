"""The port stands alone: ``tpucfn_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package, import cleanly where JAX cannot be
imported at all, run on the card unless told otherwise, and keep their
copies of the JAX package's jax-free modules equal to the originals."""

import ast
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "tpucfn_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpucfn")

# (copy in the port, original in the JAX package)
VERBATIM = [("serve/kvcache.py", "serve/kvcache.py"),
            ("serve/scheduler.py", "serve/scheduler.py"),
            ("serve/frontend.py", "serve/frontend.py"),
            ("obs/registry.py", "obs/registry.py"),
            ("obs/trace.py", "obs/trace.py"),
            ("data/records.py", "data/records.py"),
            ("data/store.py", "data/store.py"),
            ("ft/heartbeat.py", "ft/heartbeat.py"),
            ("ft/policy.py", "ft/policy.py"),
            ("ft/preempt.py", "ft/preempt.py"),
            ("ft/events.py", "ft/events.py"),
            ("ft/journal.py", "ft/journal.py"),
            ("ft/chaos.py", "ft/chaos.py"),
            ("ft/coordinator.py", "ft/coordinator.py"),
            ("provision/control_plane.py", "provision/control_plane.py"),
            ("provision/provisioner.py", "provision/provisioner.py"),
            ("provision/policy.py", "provision/policy.py"),
            ("obs/server.py", "obs/server.py"),
            ("serve/spec.py", "serve/spec.py"),
            ("serve/router.py", "serve/router.py"),
            ("obs/aggregate.py", "obs/aggregate.py"),
            ("net/__init__.py", "net/__init__.py"),
            ("net/deadline.py", "net/deadline.py"),
            ("net/proxy.py", "net/proxy.py"),
            ("data/service.py", "data/service.py"),
            ("compilecache/service.py", "compilecache/service.py"),
            ("obs/timeline.py", "obs/timeline.py"),
            ("obs/postmortem.py", "obs/postmortem.py"),
            ("net/autotune.py", "net/autotune.py"),
            ("utils/env.py", "utils/env.py"),
            ("data/images.py", "data/images.py"),
            ("data/transforms.py", "data/transforms.py"),
            ("data/shapes.py", "data/shapes.py"),
            ("data/recordio.py", "data/recordio.py")]
# (copy in the port, original in the repo): files that are not Python,
# equal byte for byte
VERBATIM_FILES = [("data/csrc/tpurecord.cc", "native/tpurecord.cc")]
# modules whose imports the scans below must cover (added with the RL
# plane and the native reader, the collectives and context parallelism)
SCANNED = ("rl/__init__.py", "rl/env.py", "rl/replay.py", "rl/learner.py",
           "rl/actor.py", "rl/loop.py", "data/native.py",
           "examples/anakin_rl.py", "collectives/__init__.py",
           "collectives/ops.py", "kernels/ring_attention.py",
           "kernels/ulysses.py")
METRICS_DEFS = ("nearest_rank", "Counter", "Gauge", "ComputedGauge", "Summary")
# the port's own versions in obs/metrics.py (process index from the
# process group, not from JAX)
METRICS_OWN = ("StepTimer", "MetricLogger", "device_memory_stats",
               "register_device_gauges", "register_kernel_gauges",
               "kernel_launch_counts")
# (copy in the port, original in the JAX package, definition) where the
# port keeps one function of a module that it otherwise rewrites
COPIED_DEFS = [("data/synthetic.py", "data/synthetic.py", "synthetic_tokens"),
               ("data/synthetic.py", "data/synthetic.py", "synthetic_latents"),
               ("data/synthetic.py", "data/synthetic.py",
                "_class_conditional_images"),
               ("data/synthetic.py", "data/synthetic.py", "synthetic_cifar10"),
               ("data/synthetic.py", "data/synthetic.py",
                "synthetic_imagenet"),
               ("data/convert.py", "data/convert.py", "iter_image_tree"),
               ("data/convert.py", "data/convert.py", "convert_image_tree"),
               ("data/convert.py", "data/convert.py", "iter_cifar_binary"),
               ("data/convert.py", "data/convert.py", "convert_cifar_binary"),
               ("data/convert.py", "data/convert.py", "upload_shards"),
               ("models/resnet.py", "models/resnet.py", "ResNetConfig"),
               ("cli.py", "cli/main.py", "cmd_convert_dataset"),
               ("cli.py", "cli/main.py", "cmd_stage_data"),
               ("data/packing.py", "data/packing.py", "pack_sequences"),
               ("data/convert.py", "data/convert.py", "convert_token_jsonl"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "_cache_path"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "_bucket"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "_read_table"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "_save"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "kind_has_entries"),
               ("kernels/flash_autotune.py", "kernels/flash_autotune.py",
                "lookup_speedup"),
               ("kernels/auto.py", "kernels/auto.py", "_evidence_says_flash"),
               ("bootstrap/contract.py", "bootstrap/contract.py",
                "EnvContract"),
               ("mesh/mesh.py", "mesh/mesh.py", "MeshSpec"),
               ("bootstrap/contract.py", "bootstrap/contract.py",
                "converge"),
               ("bootstrap/contract.py", "bootstrap/contract.py",
                "shrink_contract"),
               ("spec/cluster.py", "spec/cluster.py", "AcceleratorType"),
               ("spec/cluster.py", "spec/cluster.py", "_sku"),
               ("launch/launcher.py", "launch/launcher.py", "Transport"),
               ("launch/launcher.py", "launch/launcher.py", "LocalTransport"),
               ("launch/launcher.py", "launch/launcher.py", "SSHTransport"),
               ("launch/launcher.py", "launch/launcher.py", "Launcher"),
               ("launch/launcher.py", "launch/launcher.py",
                "run_with_restarts"),
               ("launch/launcher.py", "launch/launcher.py",
                "main_argv_for_script"),
               ("mesh/mesh.py", "mesh/mesh.py", "MeshSpec"),
               ("obs/goodput.py", "obs/goodput.py", "device_peak_flops"),
               ("obs/goodput.py", "obs/goodput.py", "ledger_path"),
               ("obs/goodput.py", "obs/goodput.py", "GoodputLedger"),
               ("obs/goodput.py", "obs/goodput.py", "parse_jsonl_line"),
               ("obs/goodput.py", "obs/goodput.py", "read_jsonl_counting"),
               ("obs/goodput.py", "obs/goodput.py", "host_id_from_path"),
               ("obs/goodput.py", "obs/goodput.py", "read_goodput_dir"),
               ("obs/goodput.py", "obs/goodput.py",
                "fleet_window_observation"),
               ("obs/goodput.py", "obs/goodput.py", "cost_analysis_value"),
               ("obs/goodput.py", "obs/goodput.py", "cost_analysis_flops"),
               ("obs/goodput.py", "obs/goodput.py", "read_ft_events"),
               ("obs/goodput.py", "obs/goodput.py", "host_goodput"),
               ("obs/goodput.py", "obs/goodput.py", "_incidents_from_events"),
               ("obs/goodput.py", "obs/goodput.py", "merge_goodput"),
               ("obs/goodput.py", "obs/goodput.py", "goodput_report"),
               ("obs/goodput.py", "obs/goodput.py", "append_goodput_ledger"),
               ("obs/goodput.py", "obs/goodput.py", "read_goodput_ledger"),
               ("obs/goodput.py", "obs/goodput.py", "diff_goodput_rows"),
               ("obs/goodput.py", "obs/goodput.py", "render_goodput"),
               ("obs/flight.py", "obs/flight.py", "flight_path"),
               ("obs/flight.py", "obs/flight.py", "incident_flight_path"),
               ("obs/flight.py", "obs/flight.py", "hbm_watermark"),
               ("obs/flight.py", "obs/flight.py", "write_flight_dump"),
               ("obs/flight.py", "obs/flight.py", "read_flight_file"),
               ("obs/flight.py", "obs/flight.py", "read_flight_dir"),
               ("obs/profiler.py", "obs/profiler.py", "ProfilerBusy"),
               ("obs/timeline.py", "obs/timeline.py", "ClockProbe"),
               ("obs/timeline.py", "obs/timeline.py", "probe_clock"),
               ("train/trainer.py", "train/trainer.py", "RestoreFailure"),
               ("train/trainer.py", "train/trainer.py", "TrainerObs"),
               ("cli.py", "cli/main.py", "_slo_objective"),
               ("cli.py", "cli/main.py", "cmd_data_serve"),
               ("cli.py", "cli/main.py", "cmd_compilecache_serve"),
               ("cli.py", "cli/main.py", "_parse_bytes"),
               ("cli.py", "cli/main.py", "cmd_compilecache_gc"),
               ("cli.py", "cli/main.py", "cmd_compilecache_stats"),
               ("cli.py", "cli/main.py", "cmd_chaos_proxy"),
               ("cli.py", "cli/main.py", "cmd_resize"),
               ("cli.py", "cli/main.py", "cmd_obs_goodput"),
               ("cli.py", "cli/main.py", "cmd_obs_postmortem"),
               ("cli.py", "cli/main.py", "cmd_obs_profile"),
               ("cli.py", "cli/main.py", "cmd_obs_diff"),
               ("cli.py", "cli/main.py", "_trace_merge"),
               ("cli.py", "cli/main.py", "cmd_trace_export"),
               ("cli.py", "cli/main.py", "cmd_trace_critpath"),
               ("cli.py", "cli/main.py", "cmd_trace_advise"),
               ("cli.py", "cli/main.py", "cmd_forensics_diff"),
               ("cli.py", "cli/main.py", "cmd_ft_status"),
               ("data/pipeline.py", "data/pipeline.py", "_mp_worker_main"),
               ("data/pipeline.py", "data/pipeline.py", "MultiProcessLoader"),
               ("compilecache/store.py", "compilecache/store.py",
                "CacheCorrupt"),
               ("compilecache/store.py", "compilecache/store.py",
                "CacheMismatch"),
               ("compilecache/store.py", "compilecache/store.py",
                "cache_key"),
               ("compilecache/store.py", "compilecache/store.py",
                "_payload_sha"),
               ("compilecache/store.py", "compilecache/store.py",
                "valid_key"),
               ("compilecache/store.py", "compilecache/store.py",
                "ArtifactStore"),
               ("launch/supervise.py", "launch/supervise.py",
                "set_child_subreaper"),
               ("launch/supervise.py", "launch/supervise.py", "_status_rc"),
               ("launch/supervise.py", "launch/supervise.py",
                "run_supervised"),
               ("models/moe.py", "models/moe.py", "MoEConfig"),
               ("models/hf_convert.py", "models/hf_convert.py",
                "config_from_hf"),
               ("models/hf_convert.py", "models/hf_convert.py",
                "config_from_hf_mixtral"),
               ("compat/kvstore.py", "compat/kvstore.py", "create"),
               ("compat/launch_py.py", "compat/launch_py.py", "main"),
               ("rl/loop.py", "rl/loop.py", "RLObs")]
# Names a copied definition calls by the port's own name:
# (copy, definition) -> {name in the JAX package: name in the port}.
RENAMED_CALLS = {
    ("data/pipeline.py", "MultiProcessLoader"): {
        "_jax_process_identity": "_process_identity"},
    # torch's dtypes for jnp's
    ("models/resnet.py", "ResNetConfig"): {
        "jnp.bfloat16": "torch.bfloat16", "jnp.float32": "torch.float32"},
}
# (copy, original, class, methods) where the port rewrites part of a
# class: the listed methods are copies.  ClusterSpec's TPU defaults,
# FlightRecorder's device probe (``sample_device``) and ProfileCapture's
# capture on torch.profiler are the port's own.
COPIED_METHODS = [
    ("spec/cluster.py", "spec/cluster.py", "ClusterSpec",
     ("__post_init__", "sku", "num_hosts", "num_chips", "to_json",
      "from_json", "load", "save")),
    ("obs/flight.py", "obs/flight.py", "FlightRecorder",
     ("record", "snapshot", "dump", "install_dump_handlers",
      "_dump_quietly")),
    ("obs/profiler.py", "obs/profiler.py", "ProfileCapture", ("__call__",)),
]
# (copy, name, original module, name there): module constants the port
# keeps its own copy of.
COPIED_CONSTANTS = [
    ("bootstrap/contract.py", "COORDINATOR_PORT", "bootstrap/contract.py",
     "COORDINATOR_PORT"),
    ("obs/goodput.py", "RECORDED_BUCKETS", "obs/goodput.py",
     "RECORDED_BUCKETS"),
    ("obs/goodput.py", "LEDGER_GLOB", "obs/goodput.py", "LEDGER_GLOB"),
    ("obs/goodput.py", "DERIVED_BUCKETS", "obs/goodput.py", "DERIVED_BUCKETS"),
    ("obs/goodput.py", "REPORT_BUCKETS", "obs/goodput.py", "REPORT_BUCKETS"),
    ("obs/goodput.py", "LEDGER_KINDS", "obs/goodput.py", "LEDGER_KINDS"),
    ("obs/goodput.py", "LEDGER_ROW_KINDS", "obs/goodput.py",
     "LEDGER_ROW_KINDS"),
    ("obs/flight.py", "FLIGHT_GLOB", "obs/flight.py", "FLIGHT_GLOB"),
    ("obs/flight.py", "FLIGHT_FILE_KINDS", "obs/flight.py",
     "FLIGHT_FILE_KINDS"),
    ("obs/flight.py", "HBM_WATERMARK_THRESHOLD", "obs/flight.py",
     "HBM_WATERMARK_THRESHOLD"),
    ("obs/flight.py", "HBM_WATERMARK_SUSTAIN_S", "obs/flight.py",
     "HBM_WATERMARK_SUSTAIN_S"),
    ("launch/launcher.py", "DEFAULT_INPUT_PORT", "data/service.py",
     "DEFAULT_INPUT_PORT"),
    ("launch/launcher.py", "COMPILE_CACHE_ADDRS_ENV",
     "compilecache/service.py", "COMPILE_CACHE_ADDRS_ENV"),
    ("launch/supervise.py", "PR_SET_CHILD_SUBREAPER", "launch/supervise.py",
     "PR_SET_CHILD_SUBREAPER"),
    ("compat/kvstore.py", "_SYNC_MODES", "compat/kvstore.py", "_SYNC_MODES"),
    ("compat/kvstore.py", "_ASYNC_MODES", "compat/kvstore.py",
     "_ASYNC_MODES"),
    ("data/convert.py", "_IMAGE_SUFFIXES", "data/convert.py",
     "_IMAGE_SUFFIXES"),
]
# Not copies: ``parallel/presets.py``'s ``dense_rules`` and
# ``transformer_rules`` place the JAX rules' dims on the port's layouts
# (an ``nn.Linear`` weight is (out, in), a conv kernel (out, in, kh, kw)).


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_new_modules_are_scanned():
    files = set(_port_files())
    assert all(PORT / m in files for m in SCANNED), [
        m for m in SCANNED if PORT / m not in files]


@pytest.mark.parametrize("copy,original", VERBATIM_FILES,
                         ids=[c for c, _ in VERBATIM_FILES])
def test_copied_file_equals_original(copy, original):
    assert (PORT / copy).read_bytes() == (REPO / original).read_bytes()


def test_every_module_imports_with_jax_unimportable():
    code = textwrap.dedent(f"""
        import importlib, importlib.abc, pkgutil, sys
        BLOCKED = {FORBIDDEN!r}
        for name in list(sys.modules):
            if name.split(".")[0] in BLOCKED:
                del sys.modules[name]

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError(f"{{name}} is blocked")
                return None

        sys.meta_path.insert(0, Block())
        import tpucfn_torch
        names = [m.name for m in pkgutil.walk_packages(
            tpucfn_torch.__path__, "tpucfn_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
        assert not leaked, leaked
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15


def test_entry_points_default_to_the_card():
    """With no device argument the engine and the demo raise on a machine
    without a card, rather than quietly serving from the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    from tpucfn_torch.models.llama import Llama, LlamaConfig
    from tpucfn_torch.serve.engine import ServeEngine, demo_llama_engine

    cfg = LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_llama_engine("nano")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(Llama(cfg, decode=True), max_batch=1, cache_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine.from_llama(cfg, {}, max_batch=1)
    from tpucfn_torch.cli import main

    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["serve", "--preset", "nano", "--synthetic", "1"])


def _without_imports(src: str) -> list[str]:
    """Source lines minus every import statement (all its lines)."""
    drop = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            drop.update(range(node.lineno, node.end_lineno + 1))
    return [line for i, line in enumerate(src.splitlines(), 1)
            if i not in drop]


@pytest.mark.parametrize("copy,original", VERBATIM, ids=[c for c, _ in VERBATIM])
def test_copied_module_equals_original_but_imports(copy, original):
    ported = (PORT / copy).read_text()
    orig = (REPO / "tpucfn" / original).read_text()
    assert _without_imports(ported) == _without_imports(orig)


def _definitions(src: str) -> dict[str, str]:
    lines = src.splitlines()
    return {node.name: "\n".join(lines[node.lineno - 1:node.end_lineno])
            for node in ast.parse(src).body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("name", METRICS_DEFS)
def test_copied_metrics_definitions_equal_originals(name):
    ported = _definitions((PORT / "obs/metrics.py").read_text())
    orig = _definitions((REPO / "tpucfn/obs/metrics.py").read_text())
    assert ported[name] == orig[name]
    assert set(ported) == set(METRICS_DEFS) | set(METRICS_OWN)


@pytest.mark.parametrize("copy,original,name", COPIED_DEFS,
                         ids=[n for _, _, n in COPIED_DEFS])
def test_copied_definitions_equal_originals(copy, original, name):
    ported = _definitions((PORT / copy).read_text())
    orig = _definitions((REPO / "tpucfn" / original).read_text())[name]
    for theirs, ours in RENAMED_CALLS.get((copy, name), {}).items():
        orig = orig.replace(theirs, ours)
    # import statements inside a definition name the port's modules
    assert _without_imports(ported[name]) == _without_imports(orig)


def _methods(src: str, cls: str) -> dict[str, str]:
    lines = src.splitlines()
    node = next(n for n in ast.parse(src).body
                if isinstance(n, ast.ClassDef) and n.name == cls)
    return {m.name: textwrap.dedent("\n".join(
                lines[m.lineno - 1 - len(m.decorator_list):m.end_lineno]))
            for m in node.body if isinstance(m, ast.FunctionDef)}


@pytest.mark.parametrize(
    "copy,original,cls,name",
    [(c, o, k, m) for c, o, k, ms in COPIED_METHODS for m in ms],
    ids=[f"{k}.{m}" for _, _, k, ms in COPIED_METHODS for m in ms])
def test_copied_methods_equal_originals(copy, original, cls, name):
    ported = _methods((PORT / copy).read_text(), cls)
    orig = _methods((REPO / "tpucfn" / original).read_text(), cls)
    assert _without_imports(ported[name]) == _without_imports(orig[name])


def _constants(src: str) -> dict[str, str]:
    out = {}
    for node in ast.parse(src).body:
        target = (node.targets[0] if isinstance(node, ast.Assign)
                  else node.target if isinstance(node, ast.AnnAssign)
                  else None)
        if isinstance(target, ast.Name) and node.value is not None:
            out[target.id] = ast.dump(node.value)
    return out


@pytest.mark.parametrize("copy,name,original,orig_name", COPIED_CONSTANTS,
                         ids=[f"{c}:{n}" for c, n, _, _ in COPIED_CONSTANTS])
def test_copied_constants_equal_originals(copy, name, original, orig_name):
    ported = _constants((PORT / copy).read_text())
    orig = _constants((REPO / "tpucfn" / original).read_text())
    assert ported[name] == orig[orig_name]
