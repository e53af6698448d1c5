"""Port parity for the LM stack's configs, layers and full-sequence forward.

For every arch of ``ARCH_IDS`` at its smoke config (plus pixtral with the
IP2 vision frontend), the reference's seed-0 weights are carried across by
``params_from_numpy`` and the same numpy batch runs through both packages:
``forward`` logits and ``moe_aux`` within 1e-5, ``loss_fn`` (forward only)
within 1e-5. Besides: the configs field for field, ``param_count`` and
``applicable_shapes``; the port's own ``init_params`` tree with the
reference's keystr paths, shapes and dtypes; ``quantize_kv`` codes exact;
MoE at a binding capacity, with exact ties in the router, dropping the
reference's (token, expert) pairs; ``TokenStream`` bitwise; the
``serve_lm`` example on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro import models as JM
from repro.checkpoint.manager import _flatten_with_paths
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenStream as JTokenStream
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro_torch import configs as t_configs
from repro_torch import models as TM
from repro_torch.convert import params_from_numpy, tree_flatten_with_paths
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.examples import serve_lm
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe

ATOL = 1e-5
B, S = 2, 16
ARCHS = list(j_configs.ARCH_IDS) + ["pixtral-12b-ip2"]


def smoke_pair(arch: str):
    """(reference cfg, port cfg) at the smoke size; ``pixtral-12b-ip2`` is
    pixtral with the IP2 vision frontend."""
    base = arch.removesuffix("-ip2")
    jc, tc = j_configs.smoke_config(base), t_configs.smoke_config(base)
    if arch.endswith("-ip2"):
        jc = dataclasses.replace(jc, vision_frontend="ip2")
        tc = dataclasses.replace(tc, vision_frontend="ip2")
    return jc, tc


def make_batch(cfg, s=S, seed=0) -> dict:
    """numpy batch: tokens, and the image / frame inputs the arch takes."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, size=(B, s)).astype(np.int32)}
    if cfg.is_vlm:
        if cfg.vision_frontend == "ip2":
            edge = cfg.ip2_patch * 2
            b["images_rgb"] = rng.uniform(size=(B, edge, edge, 3)).astype(np.float32)
        else:
            b["image_embeds"] = rng.normal(size=(B, cfg.n_image_tokens, 1024)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["frames"] = rng.normal(size=(B, cfg.n_encoder_frames, cfg.d_model)).astype(np.float32)
    return b


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def carried(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def arch_run(request):
    """Reference weights, batch and outputs for one arch (computed once)."""
    jc, tc = smoke_pair(request.param)
    jp = JM.init_params(jax.random.PRNGKey(0), jc)
    batch = make_batch(jc)
    jl, jaux = jax.jit(lambda p, b: JM.forward(p, b, jc))(jp, to_jax(batch))
    jloss, jm = jax.jit(lambda p, b: JM.loss_fn(p, b, jc))(jp, to_jax(batch))
    return {"arch": request.param, "jc": jc, "tc": tc, "jp": jp, "tp": carried(jp),
            "batch": batch, "logits": np.asarray(jl), "aux": float(jaux["moe_aux"]),
            "loss": float(jloss), "ce": float(jm["ce"])}


def test_forward_matches_reference(arch_run):
    r = arch_run
    with torch.no_grad():
        logits, aux = TM.forward(r["tp"], to_torch(r["batch"]), r["tc"])
    assert logits.shape == r["logits"].shape
    np.testing.assert_allclose(logits.numpy(), r["logits"], atol=ATOL, rtol=0)
    assert float(aux["moe_aux"]) == pytest.approx(r["aux"], abs=ATOL)
    if r["jc"].moe is not None:
        assert r["aux"] > 0.0


def test_loss_forward_matches_reference(arch_run):
    r = arch_run
    with torch.no_grad():
        loss, m = TM.loss_fn(r["tp"], to_torch(r["batch"]), r["tc"])
    assert float(loss) == pytest.approx(r["loss"], abs=ATOL)
    assert float(m["ce"]) == pytest.approx(r["ce"], abs=ATOL)


def _jax_paths(tree):
    paths, leaves, _ = _flatten_with_paths(tree)
    return [(p, tuple(np.shape(x)), np.asarray(x).dtype.name) for p, x in zip(paths, leaves)]


def _torch_paths(tree):
    return [(p, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in tree_flatten_with_paths(tree)]


def test_init_params_tree_is_the_reference_tree(arch_run):
    """The port's own init: the reference's keystr paths, shapes, dtypes."""
    r = arch_run
    tp = TM.init_params(torch.Generator().manual_seed(0), r["tc"], device="cpu")
    assert _torch_paths(tp) == _jax_paths(r["jp"])
    tb = TM.init_params(torch.Generator().manual_seed(0), r["tc"], dtype=torch.bfloat16,
                        device="cpu")
    jb = JM.init_params(jax.random.PRNGKey(0), r["jc"], dtype=jnp.bfloat16)
    assert _torch_paths(tb) == _jax_paths(jb)


def test_unroll_layers_equals_loop():
    jc, tc = smoke_pair("llama3-8b")
    tc = dataclasses.replace(tc, n_layers=4)
    tp = TM.init_params(torch.Generator().manual_seed(1), tc, device="cpu")
    batch = to_torch(make_batch(tc))
    a, _ = TM.forward(tp, batch, tc)
    b, _ = TM.forward(tp, batch, dataclasses.replace(tc, unroll_layers=True))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=0)


# ---- configs -------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(j_configs.all_configs()))
def test_registered_configs_match_reference(arch):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert t_configs.applicable_shapes(tc) == j_configs.applicable_shapes(jc)
    assert tc.layer_kinds == jc.layer_kinds
    assert tc.is_subquadratic == jc.is_subquadratic
    assert tc.d_inner_xlstm == jc.d_inner_xlstm
    if arch != "ip2-vit":
        assert dataclasses.asdict(t_configs.smoke_config(arch)) \
            == dataclasses.asdict(j_configs.smoke_config(arch))


def test_registry_matches_reference():
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    assert t_configs.arch_shape_cells() == j_configs.arch_shape_cells()
    assert t_configs.arch_shape_cells(True) == j_configs.arch_shape_cells(True)
    assert {k: dataclasses.asdict(v) for k, v in t_configs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()}
    for name in ("ATTN", "LOCAL_ATTN", "MOE", "RECURRENT", "MLSTM", "SLSTM"):
        assert getattr(t_configs, name) == getattr(j_configs, name)
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get_config("gpt-17")


# ---- layers ----------------------------------------------------------------

@pytest.mark.parametrize("tp_size,n_heads,n_kv", [(1, 9, 3), (4, 6, 2), (16, 40, 8),
                                                  (16, 10, 1), (3, 4, 4)])
def test_head_geometry_matches_reference(tp_size, n_heads, n_kv):
    jc = dataclasses.replace(j_configs.get_config("smollm-135m"), n_heads=n_heads,
                             n_kv_heads=n_kv)
    tc = dataclasses.replace(t_configs.get_config("smollm-135m"), n_heads=n_heads,
                             n_kv_heads=n_kv)
    assert t_attn.head_geometry(tc, t_layers.ParallelPlan(tp=tp_size)) \
        == j_attn.head_geometry(jc, j_layers.ParallelPlan(tp=tp_size))


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_kinds_match_reference(kind):
    jp = jax.tree.map(np.asarray, j_layers.init_mlp(jax.random.PRNGKey(3), 24, 40, kind))
    x = np.random.default_rng(0).normal(size=(2, 5, 24)).astype(np.float32)
    want = np.asarray(j_layers.apply_mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x), kind))
    got = t_layers.apply_mlp(params_from_numpy(jp, device="cpu"), torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    tp = t_layers.init_mlp(torch.Generator().manual_seed(0), 24, 40, kind)
    assert {k: tuple(v.shape) for k, v in tp.items()} == {k: v.shape for k, v in jp.items()}


def test_unknown_mlp_kind_raises_like_reference():
    with pytest.raises(ValueError, match="relu"):
        t_layers.init_mlp(torch.Generator(), 4, 8, "relu")
    with pytest.raises(ValueError, match="relu"):
        t_layers.apply_mlp({}, torch.zeros(1, 4), "relu")
    with pytest.raises(ValueError, match="relu"):
        j_layers.init_mlp(jax.random.PRNGKey(0), 4, 8, "relu")


def test_rope_and_layer_norm_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(100, 107, dtype=np.int32)
    for theta in (10_000.0, 500_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            t_layers.rope_freqs(16, theta).numpy(), np.asarray(j_layers.rope_freqs(16, theta)),
            rtol=1e-6, atol=0)
        want = np.asarray(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
        got = t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    g, b = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    want = np.asarray(j_layers.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)))
    got = t_layers.layer_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_quantize_kv_codes_exact():
    rng = np.random.default_rng(2)
    kv = rng.normal(size=(3, 9, 2, 32)).astype(np.float32) * rng.uniform(
        0.01, 10, size=(3, 9, 2, 1)).astype(np.float32)
    kv[0, 0, 0] = 0.0                              # all-zero row: the 1e-8 floor
    kv[1, 2, 1, :4] = [127.0, -127.0, 63.5, -63.5]  # halves on the code grid
    jc, js = j_attn.quantize_kv(jnp.asarray(kv))
    tc, ts = t_attn.quantize_kv(torch.from_numpy(kv))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


# ---- MoE --------------------------------------------------------------------

def _reference_dropped(jp, h, cfg):
    """The reference's dispatch (``repro.models.moe.apply_moe`` lines
    78-98) on its own router: the (token, expert) pairs past capacity."""
    m = cfg.moe
    flat = h.reshape(-1, h.shape[-1])
    t = flat.shape[0]
    probs = jax.nn.softmax((flat @ jp["router"]).astype(jnp.float32), axis=-1)
    _, ids = jax.lax.top_k(probs, m.top_k)
    cap = int(t * m.top_k / m.n_experts * m.capacity_factor)
    cap = max(8, -(-cap // 8) * 8)
    flat_ids = ids.reshape(-1)
    order = jnp.argsort(flat_ids)
    sorted_ids = flat_ids[order]
    start = jnp.searchsorted(sorted_ids, jnp.arange(m.n_experts), side="left")
    pos_in_e = jnp.arange(t * m.top_k) - start[sorted_ids]
    keep = np.asarray(pos_in_e < cap)
    tok = np.asarray(order // m.top_k)
    return sorted({(int(a), int(e)) for a, e, k in zip(tok, np.asarray(sorted_ids), keep)
                   if not k}), np.asarray(ids)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("tied", [False, True])
def test_moe_binding_capacity_drops_reference_pairs(arch, tied):
    """Capacity factor 0.5: 8 rows per expert for 64 assignments, so many
    drop. With ``tied`` the router's columns for experts 1 and 2 are equal,
    so every token ties between them: the lower expert must win top-k and
    the stable sort must keep the reference's order."""
    jc, tc = smoke_pair(arch)
    jc = dataclasses.replace(jc, moe=dataclasses.replace(jc.moe, capacity_factor=0.5))
    tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe, capacity_factor=0.5))
    jp = jax.tree.map(np.array, j_moe.init_moe(jax.random.PRNGKey(4), jc))
    if tied:
        jp["router"][:, 2] = jp["router"][:, 1]
    h = np.random.default_rng(5).normal(size=(2, 16, jc.d_model)).astype(np.float32)
    want_drop, want_ids = _reference_dropped(jax.tree.map(jnp.asarray, jp), jnp.asarray(h), jc)
    tp = params_from_numpy(jp, device="cpu")
    _, _, ids = t_moe.route(tp, torch.from_numpy(h).reshape(-1, jc.d_model), tc)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    d = t_moe.dispatch(ids, tc.moe.n_experts, t_moe.capacity(tc, 32))
    got_drop = sorted({(int(a), int(e)) for a, e, k in zip(
        d["tok_of"].numpy(), d["expert"].numpy(), d["keep"].numpy()) if not k})
    assert got_drop == want_drop and len(got_drop) > 0
    jo, jaux = j_moe.apply_moe(jax.tree.map(jnp.asarray, jp), jnp.asarray(h), jc)
    to, taux = t_moe.apply_moe(tp, torch.from_numpy(h), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    assert float(taux) == pytest.approx(float(jaux), abs=1e-7)


# ---- data --------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, {"seed": 7, "vocab": 49_152, "seq_len": 33, "global_batch": 6}])
def test_token_stream_bitwise(kw):
    js, ts = JTokenStream(JDataConfig(**kw)), TokenStream(DataConfig(**kw))
    assert dataclasses.asdict(DataConfig(**kw)) == dataclasses.asdict(JDataConfig(**kw))
    for step in (0, 1, 17):
        for host_id, n_hosts in ((0, 1), (1, 2)):
            a, b = ts.batch(step, host_id, n_hosts), js.batch(step, host_id, n_hosts)
            assert a.keys() == b.keys()
            assert a["tokens"].dtype == b["tokens"].dtype
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


# ---- the example -------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arch", "smollm-135m", "--cache", "int8"],
    ["--arch", "whisper-tiny", "--cache", "float32", "--temperature", "0.8"],
    ["--arch", "pixtral-12b", "--batch", "2"],
])
def test_serve_lm_example_runs_on_cpu(argv, capsys):
    gen = serve_lm.main(argv + ["--device", "cpu", "--prompt-len", "8", "--gen", "5"])
    assert gen.shape[1] == 5 and gen.dtype == torch.int32
    out = capsys.readouterr().out
    assert "prefill" in out and "tok/s" in out
