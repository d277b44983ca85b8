"""The port's dry-run (``repro_torch.launch.{shapes,dryrun}`` and the
counting in ``launch/roofline.py``) against the JAX reference, in
process, on the CPU, with no compile.

The reference's cells are built on ``jax.sharding.AbstractMesh`` (no
devices) with its parameter shapes traced once per architecture
(``jax.eval_shape``); every cell of both production meshes is held to
them: argument shapes and dtypes, input and output specs, and every
leaf's per-device shape.  Then the meta initialisation, the flop and
byte counter (a step on ``meta`` counts what the same step counts on
real CPU tensors; the full-width flops against a formula), the MSF
engines' exchange bytes against a replay's ``ExchangeStats``, and the
launcher's records against the keys the reference's code writes.
"""
import ast
import dataclasses
import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from torch.utils.flop_counter import FlopCounterMode

import repro.configs.base as ref_configs
import repro.launch.shapes as ref_shapes
import repro.models.model as ref_model
import repro.models.sharding as ref_shd
from repro_torch.configs.base import get_arch
from repro_torch.core.distributed import build_dist_graph, distributed_msf
from repro_torch.core.distributed_sharded import (make_sharded_mst_step,
                                                  plan_sharded_msf)
from repro_torch.core.plan import synthetic_plan
from repro_torch.data import generators
from repro_torch.launch import dryrun, shapes
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.launch.roofline import (cost_summary, model_flops,
                                         plan_exchange_bytes,
                                         replicated_exchange_bytes)
from repro_torch.models import sharding
from repro_torch.models.model import Params, init_params
from repro_torch.train.optimizer import AdamWState

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ref_configs.ARCH_IDS
MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data",
                                                        "model"))]
_REF_PARAMS = {}


def _ref_params(arch):
    """The reference's parameter shapes, traced once per architecture."""
    if arch not in _REF_PARAMS:
        cfg = ref_configs.get_arch(arch).config
        _REF_PARAMS[arch] = jax.eval_shape(
            partial(ref_model.init_params, cfg), jax.random.key(0))
    return _REF_PARAMS[arch]


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _ref_table(tree, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return {"/".join(_key(k) for k in path): leaf for path, leaf in flat}


def _port_dtype(dt):
    return str(dt).replace("torch.", "")


def _same_specs(port_specs, ref_shardings):
    """The port's spec tree equals the reference's sharding tree: every
    leaf with a spec (``None`` leaves none on the reference's side)."""
    got = {p: s for p, s in shapes.spec_table(port_specs).items()
           if s is not None}
    want = {p: tuple(s.spec) for p, s in _ref_table(
        ref_shardings, lambda x: isinstance(x, NamedSharding)).items()}
    assert got == want


def test_shapes_and_support_equal_reference():
    assert shapes.SHAPES == ref_shapes.SHAPES
    for arch in ARCHS:
        for shape_id in ref_shapes.SHAPES:
            assert shapes.cell_supported(get_arch(arch).config, shape_id) \
                == ref_shapes.cell_supported(
                    ref_configs.get_arch(arch).config, shape_id)


@pytest.mark.parametrize("arch", ARCHS)
def test_cells_equal_reference(arch, monkeypatch):
    """Every cell of both production meshes: argument shapes and dtypes,
    input and output specs and per-device shapes equal the reference's
    ``build_step`` on an ``AbstractMesh``; decode cells again under
    ``shard_logits=True`` and ``cache_shard="sequence"``, and with the
    caches donated.  The meta parameters equal ``jax.eval_shape``'s."""
    pshape = _ref_params(arch)
    monkeypatch.setattr(ref_shapes, "params_and_shardings",
                        lambda cfg, mesh: (pshape, ref_shd.param_shardings(
                            pshape, mesh)))
    t0 = time.perf_counter()
    meta = init_params(get_arch(arch).config, None, "meta")
    assert time.perf_counter() - t0 < 1.0
    assert all(t.device.type == "meta" for t in meta.parameters())
    assert {p: (s, _port_dtype(d)) for p, (s, d) in
            shapes.leaf_table(meta).items()} == \
        {p: (tuple(s.shape), str(s.dtype)) for p, s in
         _ref_table(pshape).items()}
    for dims, axes in MESHES:
        ref_mesh = AbstractMesh(dims, axes)
        mesh = make_mesh(dims, axes)
        for shape_id, info in ref_shapes.SHAPES.items():
            variants = [{}]
            if info["kind"] == "decode":
                variants.append(dict(shard_logits=True,
                                     cache_shard="sequence"))
            for over in variants:
                cfg_r = dataclasses.replace(
                    ref_configs.get_arch(arch).config, **over)
                cfg_p = dataclasses.replace(get_arch(arch).config, **over)
                if not ref_shapes.cell_supported(cfg_r, shape_id)[0]:
                    continue
                donate = info["kind"] == "decode"
                want = ref_shapes.build_step(cfg_r, shape_id, ref_mesh,
                                             donate_caches=donate)
                got = shapes.build_step(cfg_p, shape_id, mesh,
                                        donate_caches=donate)
                assert len(got) == len(want)
                if donate:
                    assert got[4] == want[4] == (1,)
                _, args, in_sh, out_sh = got[:4]
                ref_args = _ref_table(want[1])
                table = shapes.leaf_table(args)
                assert {p: (s, _port_dtype(d)) for p, (s, d) in
                        table.items()} == \
                    {p: (tuple(s.shape), str(s.dtype))
                     for p, s in ref_args.items()}, (shape_id, over)
                _same_specs(in_sh, want[2])
                _same_specs(out_sh, want[3])
                specs = shapes.spec_table(in_sh)
                ref_sh = _ref_table(want[2], lambda x: isinstance(
                    x, NamedSharding))
                for path, (shape, _) in table.items():
                    assert sharding.shard_shape(shape, specs[path], mesh) \
                        == tuple(ref_sh[path].shard_shape(shape)), path


def test_meta_init_draws_nothing_and_cpu_draws_unchanged():
    cfg = get_arch("llama3.2-3b").smoke
    got = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(0)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen)
    unembed = 0.02 * torch.randn((cfg.d_model, cfg.vocab_size),
                                 generator=gen)
    assert torch.equal(got["embed"], embed.to(cfg.torch_dtype))
    assert torch.equal(got["unembed"], unembed.to(cfg.torch_dtype))
    with pytest.raises(ValueError, match="generator"):
        init_params(cfg, None, "cpu")


def _real(tree, gen):
    """A CPU tree of the meta tree's shapes and dtypes: floats drawn,
    integers (tokens, positions, the step count) zero."""
    def one(t):
        if t.dtype.is_floating_point:
            return (0.02 * torch.randn(t.shape, generator=gen)).to(t.dtype)
        return torch.zeros(t.shape, dtype=t.dtype)
    if isinstance(tree, Params):
        return tree.map(one)
    if isinstance(tree, AdamWState):
        return AdamWState(*(_real(x, gen) for x in tree))
    return shapes.map_tree(one, tree)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-v2-236b"])
@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_meta_count_equals_cpu_count(arch, kind):
    """A step on meta tensors counts exactly the flops and bytes of the
    same step on real CPU tensors (smoke widths, a (2, 2) mesh)."""
    cfg = get_arch(arch).smoke
    mesh = make_mesh((2, 2), ("data", "model"))
    info = {"kind": kind, "seq": 16, "batch": 4}
    step, args = shapes.build_step(cfg, info, mesh)[:2]
    meta, _ = cost_summary(step, args)
    gen = torch.Generator().manual_seed(0)
    real_args = tuple(_real(a, gen) for a in args)
    assert real_args[0]["embed"].device.type == "cpu"
    step, _ = shapes.build_step(cfg, info, mesh)[:2]
    cpu, _ = cost_summary(step, real_args)
    assert meta["flops"] > 0 and meta["bytes"] > 0
    assert meta == cpu


def _llama_formula(cfg, info):
    """Flops of llama3.2-3b's step as ``FlopCounterMode`` counts it,
    derived before the count: the products alone (element-wise ops count
    0), the embedding a gather.  Per token, a layer's weights P_layer
    cost 2 P_layer forward and 4 backward; the remat recomputes a
    layer's forward up to its last saved tensor, so without the MLP's
    down projection (2 (P_layer - D F)); the unembedding, outside the
    remat, 6 V D.  The naive attention forms the full S x S scores: QK^T
    and PV are 2 S H hd flops a token each, forward, recomputed, and
    twice in the backward: 16 S H hd a token a layer.  Decode: 2 P a
    token, and 4 T H hd a layer over all T cache rows."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    p_layer = D * H * hd * 2 + 2 * D * KV * hd + 3 * D * F
    B, S = info["batch"], info["seq"]
    if info["kind"] == "train":
        T = B * S
        return T * (L * (6 * p_layer + 2 * (p_layer - D * F)
                         + 16 * S * H * hd) + 6 * V * D)
    return B * (L * (2 * p_layer + 4 * S * H * hd) + 2 * V * D)


@pytest.mark.parametrize("shape_id,band", [
    # train_4k: (8 P_layer - 2 D F) L + 6 V D + 16 S H hd L over
    # 6 N + 1.5 * 4 S H hd L (model_flops: causal half, no remat, the
    # embedding counted as a product) = 3.056e16 / 2.485e16
    ("train_4k", (1.22, 1.24)),
    # decode_32k: 2 (N - V D) + 4 T H hd L over 2 N + 4 T H hd L
    # = 2.266e12 / 2.366e12
    ("decode_32k", (0.95, 0.96)),
])
def test_full_width_flops_within_band_of_model_flops(shape_id, band):
    cfg = get_arch("llama3.2-3b").config
    info = shapes.SHAPES[shape_id]
    step, args = shapes.build_step(cfg, shape_id, make_production_mesh())[:2]
    with FlopCounterMode(display=False) as counter:  # cost_summary's flops
        step(*args)
    flops = counter.get_total_flops()
    assert flops == _llama_formula(cfg, info)
    ratio = flops / model_flops(
        cfg, info, backward=info["kind"] == "train")
    assert band[0] < ratio < band[1], ratio


# ---------------------------------------------------------------------------
# MSF exchange bytes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gnm512():
    u, v, w, n = generators.generate("gnm", 512, avg_degree=8.0, seed=3)
    g, _ = build_dist_graph(u, v, w, n, 8, device="cpu")
    return g, n


@pytest.mark.parametrize("layout", [8, (4, 2)])
def test_plan_exchange_bytes_equal_replay(gnm512, layout):
    """``plan_exchange_bytes`` equals ``ExchangeStats.bytes`` of a replay
    through ``make_sharded_mst_step(plan=...)``: exactly with
    ``adaptive_doubling`` off, an upper bound with it on.  The synthetic
    plan (no cache), and measured plans with the ghost cache (flat push;
    on the grid, the grid push too)."""
    g, n = gnm512
    sizes = layout if isinstance(layout, tuple) else (layout,)
    plans = [synthetic_plan(n, g.cap_total, 8)]
    for push in ("flat", "grid") if len(sizes) == 2 else ("flat",):
        plans.append(plan_sharded_msf(g, n, layout, ghost_push=push))
    assert plans[-1].ghost is not None
    for plan in plans:
        for adaptive in (False, True):
            pl = plan._replace(adaptive_doubling=adaptive)
            step, _ = make_sharded_mst_step(n, g.cap_total, layout, plan=pl)
            got = float(step(*g)[5].bytes)
            want = plan_exchange_bytes(pl, sizes)
            if adaptive:
                assert got <= want
            else:
                assert got == want


@pytest.mark.parametrize("local_preprocessing", [True, False])
def test_replicated_exchange_bytes_equal_engine(gnm512, local_preprocessing):
    g, n = gnm512
    *_, st = distributed_msf(g, n, 8, local_preprocessing=local_preprocessing)
    assert float(st.bytes) == replicated_exchange_bytes(
        n, 8, int(st.rounds), local_preprocessing=local_preprocessing)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _reference_record_keys():
    """The keys the reference's ``dryrun.py`` writes into an ``ok``
    record, read off its source: ``run_cell`` with ``compile_cell``'s
    dict, ``run_mst_cell`` by engine (the ``rec[prefix + ...]`` keys of
    its ``compile_step`` once per prefix a branch passes).  Nothing is
    imported or compiled.  Failure (``error``, ``trace``) and skip
    (``reason``) keys are left out."""
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}

    def assigned(node):
        for a in ast.walk(node):
            if isinstance(a, ast.Assign):
                for t in a.targets:
                    yield t, a.value

    def constants(node):
        keys = set()
        for t, value in assigned(node):
            if isinstance(t, ast.Name) and t.id == "rec" \
                    and isinstance(value, ast.Dict):
                keys |= {k.value for k in value.keys}
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id == "rec" and isinstance(t.slice,
                                                           ast.Constant):
                keys.add(t.slice.value)
        return keys

    def templates(node):
        return {t.slice.right.value for t, _ in assigned(node)
                if isinstance(t, ast.Subscript)
                and isinstance(t.slice, ast.BinOp)}

    def prefixes(node):
        return {""} | {k.value.value for c in ast.walk(node)
                       if isinstance(c, ast.Call) for k in c.keywords
                       if k.arg == "prefix"}

    ret = next(n.value for n in ast.walk(funcs["compile_cell"])
               if isinstance(n, ast.Return))
    lm = constants(funcs["run_cell"]) | {k.value for k in ret.keys}
    mst = funcs["run_mst_cell"]
    branch = next(n for n in ast.walk(mst) if isinstance(n, ast.If)
                  and "engine" in ast.unparse(n.test))
    body, orelse = ast.Module(branch.body, []), ast.Module(branch.orelse, [])
    tmpl = templates(mst)
    outside = constants(mst) - constants(body) - constants(orelse)
    sharded = outside | constants(body) | {p + k for p in prefixes(body)
                                           for k in tmpl}
    replicated = outside | constants(orelse) | tmpl
    drop = {"error", "trace", "reason"}
    return {"lm": lm - drop, "sharded": sharded - drop,
            "replicated": replicated - drop}


def test_launcher_records_have_the_reference_keys(tmp_path, capsys):
    keys = _reference_record_keys()
    assert {"useful_ratio", "extrapolated", "lower_s"} <= keys["lm"]
    assert {"flat_memory", "plan_source"} <= keys["sharded"]
    assert "plan" not in keys["replicated"]
    cases = [(["--arch", "mamba2-130m", "--shape", "decode_32k",
               "--mesh", "multi"], "lm", 1),
             (["--mst", "--mst-engine", "sharded"], "sharded", 2),
             (["--mst"], "replicated", 2)]
    for argv, kind, count in cases:
        out = tmp_path / f"{kind}.json"
        assert dryrun.main(argv + ["--out", str(out)]) == 0
        recs = json.loads(out.read_text())
        assert len(recs) == count
        for rec in recs:
            assert rec["status"] == "ok"
            assert set(rec) - set(dryrun.PORT_KEYS) == keys[kind], kind
            assert rec["why"]
    assert "0 failed" in capsys.readouterr().out
    mesh = make_production_mesh(multi_pod=True)
    rec = dryrun.run_cell("llama3.2-3b", "long_500k", mesh, "multi")
    assert rec["status"] == "skipped"
    assert rec["reason"] == ref_shapes.cell_supported(
        ref_configs.get_arch("llama3.2-3b").config, "long_500k")[1]
    with pytest.raises(ValueError, match="scan_unroll"):
        dryrun.run_cell("llama3.2-3b", "train_4k", mesh, "multi",
                        overrides={"scan_unroll": True})


def test_dryrun_imports_no_jax():
    code = ("import os, sys; flags = os.environ.get('XLA_FLAGS'); "
            "import repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; "
            "assert os.environ.get('XLA_FLAGS') == flags; print('clean')")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr
