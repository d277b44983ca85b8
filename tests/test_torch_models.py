"""The LM models of the port (``repro_torch.configs``, ``repro_torch.models``)
against the JAX reference (``repro.configs``, ``repro.models``), in process.

Parameters: the reference's tree layout (``jax.eval_shape`` of its
``init_params``), filled from ``numpy.random.default_rng`` (norms and
biases away from their init constants, so every leaf matters), fed to the
reference as numpy and to the port through ``params_from_reference``.
Each of the ten arch ids' smoke configs, in float32, runs
``forward_prefill`` and four ``forward_decode`` steps (per-row write
positions) in both packages; the logits and the caches after every step
must agree within 1e-4 of the largest reference magnitude, and two decode
steps resumed from the reference's caches (``caches_from_reference``)
too.  The options the reference's tests cover (blockwise attention, the
int8 KV cache, absorbed MLA decode), one bfloat16 run, the router and the
capacity buckets, parameter counts and the init tree follow.  The
reference's runs are computed once per module (``reference_run``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.base as ref_configs
import repro.models.layers as ref_layers
import repro.models.model as ref_model
import repro.models.moe as ref_moe
import repro_torch.configs.base as port_configs
from repro_torch.models import layers, model, moe
from repro_torch.models.convert import (caches_from_reference,
                                        params_from_reference)

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

ARCHS = ref_configs.ARCH_IDS
CPU = "cpu"
B, S, T = 2, 8, 16
DECODE_STEPS = 4
F32_REL = 1e-4   # float32: |port - ref| <= 1e-4 * max |ref|
# bfloat16: 8 significant bits (2^-8 = 3.9e-3); the two compilers round
# the chain of bf16 products and casts at different points, so a few
# ulps of the largest logit
BF16_REL = 1e-2

NORMS = {"ln", "ln1", "ln2", "ln_x", "final_norm", "enc_final_norm",
         "q_norm", "kv_norm", "norm", "D"}
SCALE = {"embed": 1.0, "conv_w": 0.2, "dt_bias": 0.5, "A_log": 0.5}


def configs(arch, **over):
    """The smoke config of ``arch`` in both packages, with ``over``
    (fields both packages have)."""
    over.setdefault("dtype", "float32")
    ref = dataclasses.replace(ref_configs.get_arch(arch).smoke, **over)
    port = dataclasses.replace(port_configs.get_arch(arch).smoke, **over)
    return ref, port


def numpy_tree(cfg, seed):
    """The reference's parameter layout filled from ``default_rng(seed)``."""
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.key(0))
    rng = np.random.default_rng(seed)

    def fill(path, sds):
        name = path[-1].key
        x = rng.standard_normal(sds.shape) * SCALE.get(name, 0.02)
        if name in NORMS:
            x = 1.0 + 5 * x
        return x.astype(sds.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                    ).astype(np.int32)}
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.frontend_len, cfg.d_model))
    return batch, enc.astype(np.float32)


def positions(t):
    """Per-row write positions of decode step ``t``."""
    return np.array([t, t + 2], np.int32)


def to_numpy(tree):
    """A copy of a port cache tree (or tensor) as numpy, float32 for
    bf16 (a copy: the port updates its caches in place)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(to_numpy(x) for x in tree))
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def ref_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)
                                             if a.dtype == jnp.bfloat16
                                             else a), tree)


def assert_close(got, ref, rel, what):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * max(np.abs(ref).max(), 1e-6)
    err = np.abs(got - ref).max() if ref.size else 0.0
    assert err <= bound, f"{what}: max|diff| {err:.3e} > {bound:.3e}"


def assert_tree_close(got, ref, rel, what):
    g_leaves, g_def = jax.tree_util.tree_flatten_with_path(got)
    r_leaves, r_def = jax.tree_util.tree_flatten_with_path(ref)
    assert [p for p, _ in g_leaves] == [p for p, _ in r_leaves], what
    for (path, g), (_, r) in zip(g_leaves, r_leaves):
        if np.issubdtype(np.asarray(r).dtype, np.integer):
            assert np.array_equal(g, r), (what, path)  # int8 cache bytes
        else:
            assert_close(g, r, rel, f"{what} {jax.tree_util.keystr(path)}")


@pytest.fixture(scope="module")
def reference_run():
    """(arch, options) -> the reference's prefill logits, per-step decode
    logits and caches, computed once per module."""
    memo = {}

    def run(arch, seed=0, **over):
        key = (arch, seed, tuple(sorted(over.items())))
        if key in memo:
            return memo[key]
        cfg, _ = configs(arch, **over)
        tree = numpy_tree(cfg, seed)
        batch, enc = inputs(cfg, seed)
        prefill = jax.jit(lambda p, b: ref_model.forward_prefill(cfg, p, b))
        step = jax.jit(lambda p, c, t, q: ref_model.forward_decode(
            cfg, p, c, t, q))
        logits = ref_numpy(prefill(tree, batch))
        caches = ref_model.init_caches(cfg, B, T)
        if cfg.family == "audio":
            caches["enc"] = jnp.asarray(enc, cfg.jdtype)
        steps = []
        for t in range(DECODE_STEPS):
            lg, caches = step(tree, caches, batch["tokens"][:, t],
                              positions(t))
            steps.append((ref_numpy(lg), jax.tree.map(np.asarray, caches)))
        memo[key] = dict(tree=tree, batch=batch, enc=enc, prefill=logits,
                         steps=steps)
        return memo[key]
    return run


def port_run(arch, ref, resume_at=None, **over):
    """The port on the reference's tree and inputs; with ``resume_at``,
    decode from the reference's caches after that many steps."""
    _, cfg = configs(arch, **over)
    params = params_from_reference(cfg, ref["tree"], CPU)
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    prefill = model.forward_prefill(cfg, params, batch)
    if resume_at is None:
        caches = model.init_caches(cfg, B, T, CPU)
        if cfg.family == "audio":
            caches["enc"] = torch.from_numpy(ref["enc"]).to(cfg.torch_dtype)
        start = 0
    else:
        caches = caches_from_reference(ref["steps"][resume_at - 1][1], CPU)
        start = resume_at
    steps = []
    for t in range(start, DECODE_STEPS):
        lg, caches = model.forward_decode(
            cfg, params, caches, batch["tokens"][:, t].long(),
            torch.from_numpy(positions(t)).long())
        steps.append((to_numpy(lg), to_numpy(caches)))
    return to_numpy(prefill), steps


def check_against(arch, ref, rel, resume_at=None, **over):
    prefill, steps = port_run(arch, ref, resume_at, **over)
    assert_close(prefill, ref["prefill"], rel, f"{arch} prefill")
    start = resume_at or 0
    for t, (lg, caches) in enumerate(steps, start):
        r_lg, r_caches = ref["steps"][t]
        assert np.isfinite(lg).all()
        assert_close(lg, r_lg, rel, f"{arch} decode step {t}")
        assert_tree_close(caches, ref_numpy(r_caches), rel,
                          f"{arch} caches after step {t}")


# ---------------------------------------------------------------------------
# every arch, float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, reference_run):
    ref = reference_run(arch)
    check_against(arch, ref, F32_REL)
    # mid-stream: two decode steps resumed from the reference's caches
    check_against(arch, ref, F32_REL, resume_at=2)


def test_bfloat16_matches_reference_within_its_bound(reference_run):
    ref = reference_run("llama3.2-3b", dtype="bfloat16")
    check_against("llama3.2-3b", ref, BF16_REL, dtype="bfloat16")


def test_decode_matches_prefill_in_the_port():
    """Teacher-forced decode ends in the logits of the parallel forward
    (float32, the port alone, 1e-4 relative)."""
    _, cfg = configs("llama3.2-3b")
    params = model.init_params(cfg, torch.Generator().manual_seed(3), CPU)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 6)))
    caches = model.init_caches(cfg, 1, 8, CPU)
    for t in range(6):
        lg, caches = model.forward_decode(cfg, params, caches, toks[:, t],
                                          torch.tensor([t]))
    want = model.forward_prefill(cfg, params, {"tokens": toks})
    assert_close(lg.numpy(), want.numpy(), F32_REL, "decode vs prefill")


# ---------------------------------------------------------------------------
# options the reference's tests cover
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,block", [("qwen2-1.5b", 3),
                                        ("deepseek-v2-236b", 3),
                                        ("whisper-small", 5)])
def test_blockwise_attention_matches_reference(arch, block, reference_run):
    """``attn_impl="blockwise"`` with a block that does not divide the
    sequence: GQA, MLA, and whisper's non-causal encoder and cross
    attention."""
    over = dict(attn_impl="blockwise", attn_block=block)
    check_against(arch, reference_run(arch, **over), F32_REL, **over)


def test_int8_kv_cache_matches_reference(reference_run):
    over = dict(kv_cache_dtype="int8")
    check_against("command-r-35b", reference_run("command-r-35b", **over),
                  F32_REL, **over)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_quant_kv_bytes_and_scales_exact(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 4, 16)).astype(np.float32)
    x[0, 0] = 0.0                              # scale clamps to 1e-8
    x[0, 1] = 0.0
    x[0, 1, :4] = [254.0, 1.0, 3.0, -5.0]      # x/scale = .5, 1.5, -2.5
    x[1, 2] *= 1e-12                           # tiny row
    x[2, 3, 5] = -2 * np.abs(x[2, 3]).max()   # negative extreme
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(xj.astype(jnp.float32)),
                              xt.float().numpy())
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    rq, rs = ref_layers._quant_kv(xj)
    pq, ps = layers._quant_kv(xt)
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    assert np.array_equal(pq.numpy(), np.asarray(rq))
    assert np.array_equal(ps.numpy(), np.asarray(rs))


def test_int8_cache_footprint_matches_reference():
    cfg_r, cfg_p = configs("command-r-35b", dtype="bfloat16",
                           kv_cache_dtype="int8")
    ref = ref_model.init_caches(cfg_r, 2, 64)
    port = model.init_caches(cfg_p, 2, 64, CPU)
    assert [(x.shape, str(x.dtype)) for x in jax.tree.leaves(ref)] == \
        [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
         for x in port]


def test_mla_absorbed_decode_matches_reference(reference_run):
    over = dict(mla_absorb=True)
    ref = reference_run("deepseek-v2-236b", **over)
    check_against("deepseek-v2-236b", ref, F32_REL, **over)
    # and the port's absorbed decode equals its own naive decode
    naive, _ = port_run("deepseek-v2-236b", ref)[1][-1]
    absorbed, _ = port_run("deepseek-v2-236b", ref, **over)[1][-1]
    assert_close(absorbed, naive, 1e-5, "absorbed vs naive decode")


# ---------------------------------------------------------------------------
# the router and the capacity buckets
# ---------------------------------------------------------------------------

def _router_inputs():
    """Gates with exact ties: dyadic inputs, so every logit is exact, and
    router columns 1 and 3 equal (token rows 0 and 4 zero: a four-way
    tie)."""
    rng = np.random.default_rng(5)
    x = rng.integers(-4, 5, (6, 8)).astype(np.float32) / 4
    x[0] = 0.0
    x[4] = 0.0
    w = rng.integers(-4, 5, (8, 4)).astype(np.float32) / 8
    w[:, 3] = w[:, 1]
    return x, w


@pytest.mark.parametrize("k", [1, 2, 3])
def test_router_topk_breaks_ties_like_lax_top_k(k):
    x, w = _router_inputs()
    rg, re_ = ref_moe.router_topk(jnp.asarray(x), jnp.asarray(w), k)
    pg, pe = moe.router_topk(torch.from_numpy(x), torch.from_numpy(w), k)
    assert pe.dtype == torch.int32
    assert np.array_equal(pe.numpy(), np.asarray(re_))
    assert_close(pg.numpy(), np.asarray(rg), 1e-6, "gates")
    assert np.array_equal(pe[0].numpy(), np.arange(k))  # ties: low first


@pytest.mark.parametrize("capacity", [1, 2, 4])
def test_bucketize_drops_what_the_reference_drops(capacity):
    x, w = _router_inputs()
    gates, experts = ref_moe.router_topk(jnp.asarray(x), jnp.asarray(w), 2)
    gates, experts = np.asarray(gates), np.asarray(experts)
    ref = ref_moe._bucketize(jnp.asarray(x), jnp.asarray(gates),
                             jnp.asarray(experts), 4, capacity)
    port = moe._bucketize(torch.from_numpy(x), torch.from_numpy(gates),
                          torch.from_numpy(experts), 4, capacity)
    for name, r, p in zip(("xbuf", "gbuf", "src", "ok"), ref, port):
        assert np.array_equal(p.numpy(), np.asarray(r)), name
    if capacity == 1:
        assert not np.asarray(ref[3]).all()  # the overflow case drops


def test_moe_local_with_overflow_matches_reference():
    cfg_r, cfg_p = configs("llama4-maverick-400b-a17b", capacity_factor=0.5)
    tree = numpy_tree(cfg_r, 6)
    lp = jax.tree.map(lambda a: a[0], tree["moe_blocks"]["moe"])
    params = params_from_reference(cfg_p, tree, CPU)
    x = np.random.default_rng(7).standard_normal((2, 8, cfg_r.d_model)
                                                 ).astype(np.float32)
    ref = np.asarray(ref_moe.moe_apply(cfg_r, lp, jnp.asarray(x)))
    got = moe.moe_apply(cfg_p, params["moe_blocks"][0]["moe"],
                        torch.from_numpy(x)).numpy()
    assert_close(got, ref, F32_REL, "moe_apply, capacity_factor 0.5")
    # under a mesh context with the default moe_impl ("gshard") the
    # reference runs moe_local too
    assert np.array_equal(moe.moe_apply(
        cfg_p, params["moe_blocks"][0]["moe"], torch.from_numpy(x),
        mesh_ctx=object()).numpy(), got)


# ---------------------------------------------------------------------------
# configs, parameter counts, the init tree
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_equal_reference(arch):
    ref = ref_configs.get_arch(arch)
    port = port_configs.get_arch(arch)
    assert port.source == ref.source
    for which in ("config", "smoke"):
        r, p = getattr(ref, which), getattr(port, which)
        fields = dataclasses.asdict(p)
        assert fields == {k: v for k, v in dataclasses.asdict(r).items()
                          if k in fields}
        # the fields the port leaves out hold their defaults in every
        # config: nothing is lost
        left_out = [f for f in dataclasses.fields(r) if f.name not in fields]
        assert all(getattr(r, f.name) == f.default for f in left_out)
        assert p.param_count() == r.param_count()
        assert p.active_param_count() == r.active_param_count()
        assert p.torch_dtype == getattr(torch, r.dtype)


def _port_layout(params):
    """{reference path: (stacked shape, dtype)} of a port tree: its
    per-layer lists folded back into a leading layer dim."""
    def leaves(node, path):
        for name in node.keys():
            child = node[name]
            key = path + (name,)
            if isinstance(child, torch.nn.ModuleList):
                layers = [dict(leaves(layer, ())) for layer in child]
                assert all(lay == layers[0] for lay in layers), key
                for sub, (shape, dt) in layers[0].items():
                    yield key + sub, ((len(child),) + shape, dt)
            elif isinstance(child, model.Params):
                yield from leaves(child, key)
            else:
                yield key, (tuple(child.shape),
                            str(child.dtype).replace("torch.", ""))
    return dict(leaves(params, ()))


def _reference_layout(cfg):
    shapes = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.key(0))
    leaves, _ = jax.tree_util.tree_flatten_with_path(shapes)
    return {tuple(p.key for p in path): (tuple(s.shape), str(s.dtype))
            for path, s in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_names_shapes_dtypes_equal_reference(arch):
    cfg_r, cfg_p = configs(arch, dtype="bfloat16")
    params = model.init_params(cfg_p, torch.Generator().manual_seed(0), CPU)
    assert _port_layout(params) == _reference_layout(cfg_r)
    assert not any(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-small", "qwen2-1.5b"])
def test_init_scales_equal_reference(arch):
    """Each leaf's init: a constant leaf (norms, biases, ``D``, ``A_log``,
    ``dt_bias``) equals the reference's exactly, a drawn leaf has its
    standard deviation within 10% (leaves of 1,000+ draws)."""
    cfg_r, cfg_p = configs(arch)
    init = jax.jit(lambda k: ref_model.init_params(cfg_r, k))
    ref = jax.tree.map(np.asarray, init(jax.random.key(0)))
    port = model.init_params(cfg_p, torch.Generator().manual_seed(0), CPU)
    leaves, _ = jax.tree_util.tree_flatten_with_path(ref)
    checked = 0
    for path, r in leaves:
        names = [p.key for p in path]
        got = (np.stack([_leaf(layer, names[1:]) for layer in port[names[0]]])
               if names[0] in model.STACKED else _leaf(port, names))
        assert got.shape == r.shape, names
        if r.std() == 0:
            assert np.array_equal(got, r), names
        elif r.size >= 1000:
            assert abs(got.std() / r.std() - 1) < 0.1, names
            checked += 1
    assert checked >= 5


def _leaf(node, names):
    for n in names:
        node = node[n]
    return node.detach().float().numpy()
