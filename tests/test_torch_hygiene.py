"""Port hygiene: the port imports neither JAX nor the JAX package, its
config dataclasses keep the reference's field names and defaults, its
entry points refuse to guess a device, and its wrappers route on the
device of their tensors without touching the CUDA build on the CPU."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.configs
import repro.configs.base
import repro.core.adc
import repro.core.analog_nl
import repro.core.frontend
import repro.core.power
import repro.core.projection
import repro.core.pwm
import repro.core.switched_cap
import repro.core.temporal
import repro.core.throughput
import repro.data.pipeline
import repro.models.backend_delta
import repro.models.layers
import repro.models.vit
import repro.optim.adamw
import repro.train.trainer
import repro.serve.engine
import repro.serve.governor
from repro.core.qth_attention import QTHSpec as RefQTHSpec
from repro.kernels.ip2_project import IP2KernelParams as RefKernelParams
import repro_torch.configs
import repro_torch.configs.base
import repro_torch.convert
import repro_torch.core.adc
import repro_torch.core.analog_nl
import repro_torch.core.frontend
import repro_torch.core.power
import repro_torch.core.projection
import repro_torch.core.pwm
import repro_torch.core.switched_cap
import repro_torch.core.qth_attention
import repro_torch.core.temporal
import repro_torch.core.throughput
import repro_torch.data.pipeline
import repro_torch.distributed.pipeline
import repro_torch.kernels.ops
import repro_torch.launch.mesh
import repro_torch.launch.shardings
import repro_torch.launch.specs
import repro_torch.models.backend_delta
import repro_torch.models.cnn
import repro_torch.models.attention
import repro_torch.models.blocks
import repro_torch.models.layers
import repro_torch.models.lm
import repro_torch.models.moe_a2a
import repro_torch.models.sharding_ctx
import repro_torch.models.rglru
import repro_torch.models.xlstm
import repro_torch.models.vit
import repro_torch.optim.adamw
import repro_torch.optim.compression
import repro_torch.train.trainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.examples import serve_lm, train_ip2_classifier, train_lm
import repro_torch.serve.engine
import repro_torch.serve.fleet
import repro_torch.serve.governor

ROOT = Path(__file__).resolve().parents[1]


def _port_files():
    return (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
            + [ROOT / "chip_smoke.py", ROOT / "tools" / "fused_embed_variants.py",
               ROOT / "tools" / "profiler_windows.py",
               ROOT / "tools" / "long_context_decode.py",
               ROOT / "tools" / "dryrun_census.py", ROOT / "tools" / "decode_drift.py",
               ROOT / "tools" / "peak_holders.py"])


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.name} imports {bad}"


def _lower_layer_files():
    base = ROOT / "src" / "repro_torch"
    return sorted(p for d in ("models", "optim", "train", "checkpoint", "distributed")
                  for p in (base / d).rglob("*.py"))


@pytest.mark.parametrize("path", _lower_layer_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_lower_layers_never_import_the_launcher(path):
    """The launcher builds on the model, optimiser and training code, never
    the reverse: their layout primitives live in ``models.sharding_ctx``."""
    bad = [m for m in _imported_modules(path) if m.startswith("repro_torch.launch")]
    assert not bad, f"{path.name} imports {bad}"


PAIRS = [
    (repro.core.pwm.QuantSpec, repro_torch.core.pwm.QuantSpec),
    (repro.core.switched_cap.SummerSpec, repro_torch.core.switched_cap.SummerSpec),
    (repro.core.analog_nl.AnalogNLSpec, repro_torch.core.analog_nl.AnalogNLSpec),
    (repro.core.adc.ADCSpec, repro_torch.core.adc.ADCSpec),
    (repro.core.projection.PatchSpec, repro_torch.core.projection.PatchSpec),
    (repro.core.temporal.TemporalSpec, repro_torch.core.temporal.TemporalSpec),
    (repro.core.frontend.FrontendConfig, repro_torch.core.frontend.FrontendConfig),
    (repro.models.vit.ViTConfig, repro_torch.models.vit.ViTConfig),
    (RefKernelParams, repro_torch.kernels.ops.IP2KernelParams),
    (repro.core.power.EnergyConstants, repro_torch.core.power.EnergyConstants),
    (repro.core.projection.ConvSpec, repro_torch.core.projection.ConvSpec),
    (RefQTHSpec, repro_torch.core.qth_attention.QTHSpec),
    (repro.core.power.SensorConfig, repro_torch.core.power.SensorConfig),
    (repro.core.power.AreaBudget, repro_torch.core.power.AreaBudget),
    (repro.core.throughput.RatePoint, repro_torch.core.throughput.RatePoint),
    (repro.optim.adamw.AdamWConfig, repro_torch.optim.adamw.AdamWConfig),
    (repro.train.trainer.TrainerConfig, repro_torch.train.trainer.TrainerConfig),
    (repro.configs.base.MoEConfig, repro_torch.configs.base.MoEConfig),
    (repro.configs.base.ModelConfig, repro_torch.configs.base.ModelConfig),
    (repro.configs.base.ShapeConfig, repro_torch.configs.base.ShapeConfig),
    (repro.models.layers.ParallelPlan, repro_torch.models.layers.ParallelPlan),
    (repro.data.pipeline.DataConfig, repro_torch.data.pipeline.DataConfig),
]
# GovernorSpec has a required field (budget_mw): compared on its fields
# in tests/test_torch_governor.py


def _plain(v):
    """A default reduced to comparable values (nested dataclasses by fields,
    JAX's and PyTorch's dtypes by name)."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) and hasattr(v, "dtype"):   # jnp.float32 and the like
        return np.dtype(v).name
    return v


@pytest.mark.parametrize("ref_cls,port_cls", PAIRS, ids=lambda c: c.__name__)
def test_config_fields_match_reference(ref_cls, port_cls):
    rf, pf = dataclasses.fields(ref_cls), dataclasses.fields(port_cls)
    assert [f.name for f in pf] == [f.name for f in rf]
    for a, b in zip(rf, pf):
        assert _plain(b.default) == _plain(a.default), a.name


@pytest.mark.parametrize("arch", sorted(repro.configs.all_configs()))
def test_registered_configs_match_reference_field_for_field(arch):
    ref, port = repro.configs.get_config(arch), repro_torch.configs.get_config(arch)
    assert type(port).__module__.startswith("repro_torch.")
    assert [f.name for f in dataclasses.fields(port)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        assert _plain(getattr(port, f.name)) == _plain(getattr(ref, f.name)), (arch, f.name)
    assert repro_torch.configs.registry.get_config.__module__ == "repro_torch.configs.registry"


def test_init_vit_tree_is_the_reference_tree():
    """The ViT builds its attention through the reference's
    ``init_attention(generator, cfg, plan, dtype)``: the tree keeps the
    reference's keys, shapes and dtypes."""
    import jax

    from repro.checkpoint.manager import _flatten_with_paths

    kw = dict(n_layers=2, d_model=48, n_heads=3, d_ff=96)
    ref = repro.models.vit.init_vit(jax.random.PRNGKey(0), repro.models.vit.ViTConfig(**kw))
    port = repro_torch.models.vit.init_vit(repro_torch.models.vit.ViTConfig(**kw),
                                           torch.Generator().manual_seed(0), device="cpu")
    paths, leaves, _ = _flatten_with_paths(ref)
    want = [(p, np.shape(x), np.asarray(x).dtype.name) for p, x in zip(paths, leaves)]
    got = [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
           for p, x in repro_torch.convert.tree_flatten_with_paths(port)]
    assert got == want


@pytest.mark.parametrize("ref_t,port_t", [
    (repro.core.power.EventCounts, repro_torch.core.power.EventCounts),
    (repro.core.frontend.CompactFeatures, repro_torch.core.frontend.CompactFeatures),
    (repro.core.frontend.CompactSelection, repro_torch.core.frontend.CompactSelection),
    (repro.core.temporal.FeatureCache, repro_torch.core.temporal.FeatureCache),
    (repro.serve.governor.GovernorControls, repro_torch.serve.governor.GovernorControls),
    (repro.models.backend_delta.BackendCache, repro_torch.models.backend_delta.BackendCache),
    (repro.serve.engine.StreamState, repro_torch.serve.engine.StreamState),
    (repro.core.power.PowerReport, repro_torch.core.power.PowerReport),
    (repro.core.adc.ADCCodes, repro_torch.core.adc.ADCCodes),
], ids=lambda c: c.__name__)
def test_named_tuple_fields_match_reference(ref_t, port_t):
    assert port_t._fields == ref_t._fields


@pytest.mark.parametrize("wire", ["codes", "float", "sign"])
def test_wire_payloads_keep_the_reference_tuples(wire):
    """The payloads of ``CompactFeatures`` and ``FeatureCache`` vary in dtype
    with the wire; the tuples keep the reference's fields, and each payload
    the reference's dtype."""
    import jax.numpy as jnp

    kw = dict(image_h=32, image_w=32, active_fraction=0.25)
    jc = repro.core.frontend.FrontendConfig(
        patch=repro.core.projection.PatchSpec(8, 8, n_vectors=8), **kw)
    tc = repro_torch.core.frontend.FrontendConfig(
        patch=repro_torch.core.projection.PatchSpec(8, 8, n_vectors=8), **kw)
    rng = np.random.default_rng(0)
    a = rng.normal(size=(8, 192)).astype(np.float32) * 3.2
    rgb = rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)
    dt = {"codes": (None, None), "float": (jnp.float32, torch.float32),
          "sign": (jnp.bool_, torch.bool)}[wire]
    jcf, jcache = repro.core.frontend.apply_frontend(
        {"a_rgb": jnp.asarray(a), "bias": jnp.zeros(8)}, jnp.asarray(rgb), jc,
        mode="compact", wire=wire,
        cache=repro.core.temporal.init_feature_cache(jc, (1,), dtype=dt[0]))
    tcf, tcache = repro_torch.core.frontend.apply_frontend(
        {"a_rgb": torch.from_numpy(a), "bias": torch.zeros(8)}, torch.from_numpy(rgb), tc,
        mode="compact", wire=wire,
        cache=repro_torch.core.temporal.init_feature_cache(tc, (1,), dtype=dt[1],
                                                           device="cpu"))
    assert type(tcf)._fields == type(jcf)._fields
    assert type(tcache)._fields == type(jcache)._fields
    for t, j in ((tcf.features, jcf.features), (tcache.features, jcache.features)):
        assert t.numpy().dtype == np.asarray(j).dtype


def test_entry_points_need_cuda_when_device_is_none(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = repro_torch.models.vit.ViTConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.models.vit.init_vit(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.serve.engine.SaccadeEngine(cfg, {}, capacity=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.models.cnn.init_cnn(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.core.temporal.init_feature_cache(cfg.frontend, (1,))
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.models.backend_delta.init_backend_cache(cfg, 4, (1,))
    cm = CheckpointManager(str(tmp_path))
    cm.save(0, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        cm.restore({"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        train_ip2_classifier.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.serve.fleet.SaccadeFleet(cfg, {}, n_hosts=2, capacity=1)
    lm_cfg = repro_torch.configs.smoke_config("smollm-135m")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.models.lm.init_params(torch.Generator().manual_seed(0), lm_cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.models.lm.init_decode_state(lm_cfg, repro_torch.models.layers.DEFAULT_PLAN,
                                                1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_lm.main(["--gen", "2", "--prompt-len", "2"])
    plan = repro_torch.models.layers.DEFAULT_PLAN
    xl_cfg = repro_torch.configs.smoke_config("xlstm-1.3b")
    for build in (
            lambda: repro_torch.models.attention.make_cache(lm_cfg, plan, 1, 8),
            lambda: repro_torch.models.attention.make_cache_scales(lm_cfg, plan, 1, 8),
            lambda: repro_torch.models.blocks.init_block_state("attn", lm_cfg, plan, 1, 8),
            lambda: repro_torch.models.rglru.init_rglru_state(lm_cfg, 1),
            lambda: repro_torch.models.xlstm.init_mlstm_state_cell(1, 2, 4),
            lambda: repro_torch.models.xlstm.init_mlstm_state(xl_cfg, 1),
            lambda: repro_torch.models.xlstm.init_slstm_state(xl_cfg, 1),
            lambda: repro_torch.serve.governor.init_controls(4, 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(RuntimeError, match="CUDA"):
        train_lm.main(["--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
                       "--ckpt-dir", str(tmp_path / "lm")])
    # the meshes: process-group meshes default to CUDA ranks, fleet meshes
    # to the visible CUDA devices
    for build in (lambda: repro_torch.launch.mesh.make_host_mesh(2, 2),
                  lambda: repro_torch.launch.mesh.make_production_mesh(),
                  lambda: repro_torch.launch.mesh.make_production_mesh(multi_pod=True),
                  lambda: repro_torch.serve.fleet.make_fleet_meshes(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    mesh = repro_torch.launch.mesh.LocalMesh(["cuda:0"] * 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.serve.engine.SaccadeEngine(cfg, {}, capacity=2, mesh=mesh)


def test_cpu_tensors_never_reach_the_cuda_build(monkeypatch):
    from repro_torch.kernels import _build, ops

    def refuse(name):
        raise AssertionError(f"CPU call tried to load the {name} kernel")

    monkeypatch.setattr(_build, "load", refuse)
    ops.reset_launches()
    spec = repro_torch.core.projection.PatchSpec(8, 8, n_vectors=8)
    adc = repro_torch.core.adc.ADCSpec()
    x = torch.rand((2, 4, 64), generator=torch.Generator().manual_seed(0))
    w = torch.randn((8, 64), generator=torch.Generator().manual_seed(1))
    codes = ops.ip2_project(x, w, spec, adc=adc, codes=True)
    w8, s_w = ops.quantize_weights_int8(torch.randn(8, 16))
    ops.quant_matmul_pre(codes, adc.lsb, w8, s_w)
    idx = torch.zeros((2, 3), dtype=torch.int32)
    ops.ip2_fused_embed(x, w, idx, spec, adc, w8, s_w)
    ops.ip2_project_sparse(x, w, idx, spec, adc=adc, codes=True)
    ops.ip2_project_sparse(x, w, idx, spec, adc=adc, codes=True, row_counts=torch.tensor([1, 3]))
    for fn in (ops.ip2_project_fn(spec), ops.ip2_sign_fn(spec), ops.ip2_codes_fn(spec, adc)):
        fn(x, w, spec)
        fn(x, w, spec, row_counts=torch.tensor([1, 3]))
    ops.quant_matmul(torch.randn((2, 8)), w8, s_w)
    attn = {n: torch.zeros((8, 2, 4)) for n in ("wq", "wk", "wv")}
    attn.update({n: torch.zeros((2, 4)) for n in ("bq", "bk", "bv")}, wo=torch.zeros((2, 4, 8)))
    ops.delta_attention(attn, torch.rand((2, 3, 8)), torch.ones((2, 3), dtype=torch.bool),
                        torch.tensor([3, 0]), 2)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="device"):
        ops.ip2_project(x.to("meta"), w.to("meta"), spec, adc=adc, codes=True)
