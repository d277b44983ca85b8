"""The expert-parallel MoE dispatch of the port
(``repro_torch.models.moe: moe_dispatch``, ``moe_apply`` under a
``MeshContext``) against the JAX reference.

In process: the reference test's three layouts (``(4, 2)`` data x model,
``(2, 2, 2)`` pod x data x model, and the grid schedule over the two
expert axes of ``(2, 2, 2)`` data x em x en) at capacity factor 16 equal
``moe_local`` within 5e-4 (``tests/test_moe_dispatch.py``); the grid
schedule equals the direct one bit for bit; ``moe_apply`` dispatches
exactly where the reference does.  Against the reference's own
``moe_dispatch`` on 8 virtual devices (one subprocess, ``REFERENCE``) at
the default capacity factor 1.25, where each shard's capacity drops
copies: the same tokens lose a copy in both packages and the outputs
agree within 1e-5; and ``forward_train`` through the dispatch on a
``(4, 2)`` mesh gives the reference's loss and gradients within 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model, moe
from repro_torch.models.convert import (params_from_reference,
                                        params_to_reference)
from repro_torch.models.layers import swiglu
from tests.test_torch_models import CPU, F32_REL, assert_close, configs, \
    numpy_tree
from tests.test_torch_sharded import run_reference

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
# name -> (mesh shape, axes, dp axes, ep axes, schedule)
LAYOUTS = {
    "data4-model2": ((4, 2), ("data", "model"), ("data",), ("model",),
                     "direct"),
    "pod2-data2-model2": ((2, 2, 2), ("pod", "data", "model"),
                          ("pod", "data"), ("model",), "direct"),
    "grid-data2-em2-en2": ((2, 2, 2), ("data", "em", "en"), ("data",),
                           ("em", "en"), "grid"),
}
X_SHAPE = (4, 16)     # B, S: 8 tokens a shard on every layout
LOCAL_TOL = 5e-4      # tests/test_moe_dispatch.py's bound, capacity 16
DROP_REL = 1e-5       # the port against the reference, capacity 1.25


def inputs():
    """The smoke config's first MoE layer (float32, the reference's
    layout from default_rng) and x [4, 16, D]."""
    cfg_r, cfg_p = configs(ARCH)
    tree = numpy_tree(cfg_r, 11)
    lp = {k: v[0] for k, v in tree["moe_blocks"]["moe"].items()}
    x = np.random.default_rng(12).standard_normal(
        X_SHAPE + (cfg_r.d_model,)).astype(np.float32)
    return cfg_r, cfg_p, tree, lp, x


def train_inputs(cfg):
    rng = np.random.default_rng(13)
    toks = rng.integers(0, cfg.vocab_size, (4, 9))
    return {"tokens": toks[:, :8].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


REFERENCE = """
import dataclasses
from jax.sharding import Mesh
from repro.configs.base import get_arch
from repro.models import moe as moe_lib
from repro.models.model import MeshContext, forward_train

data = dict(np.load(IN))
cfg = dataclasses.replace(get_arch(ARCH).smoke, dtype="float32",
                          moe_impl="dispatch")
lp = {k: jnp.asarray(data["lp/" + k]) for k in ("router", "wg", "wu", "wd")}
x = jnp.asarray(data["x"])
out = {}
for name, (shape, axes, dp, ep, sched) in LAYOUTS.items():
    c = dataclasses.replace(cfg, moe_dispatch=sched)
    mesh = Mesh(np.array(jax.devices()).reshape(shape), axes)
    fn = jax.jit(lambda l, xx: moe_lib.moe_dispatch(c, l, xx, mesh, dp, ep))
    out["y/" + name] = np.asarray(fn(lp, x))

# forward_train through the dispatch on the (4, 2) mesh, capacity 1.25
tree = {}
for key, val in data.items():
    if key.startswith("tree/"):
        node = tree
        *parents, leaf = key[5:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(val)
batch = {k: jnp.asarray(data["batch/" + k]) for k in ("tokens", "labels")}
mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
ctx = MeshContext(mesh, ("data",), ("model",))
loss, grads = jax.jit(jax.value_and_grad(
    lambda p, b: forward_train(cfg, p, b, ctx)))(tree, batch)
out["loss"] = np.asarray(loss)
for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
    out["grad/" + "/".join(k.key for k in path)] = np.asarray(g)
np.savez(OUT, **out)
print("OK")
"""


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    cfg_r, _, tree, lp, x = inputs()
    d = tmp_path_factory.mktemp("moe_dispatch_reference")
    arrays = {"x": x, **{"lp/" + k: v for k, v in lp.items()},
              **{"tree/" + k: v for k, v in _flat(tree)},
              **{"batch/" + k: v for k, v in train_inputs(cfg_r).items()}}
    np.savez(d / "in.npz", **arrays)
    body = (f"IN = {str(d / 'in.npz')!r}\nOUT = {str(d / 'out.npz')!r}\n"
            f"ARCH = {ARCH!r}\nLAYOUTS = {LAYOUTS!r}\n" + REFERENCE)
    assert "OK" in run_reference(body, ndev=8, timeout=600)
    with np.load(d / "out.npz") as data:
        return dict(data)


def port_layer(cfg_p, tree):
    params = params_from_reference(cfg_p, tree, CPU)
    return params["moe_blocks"][0]["moe"]


def dispatch(cfg_p, p, x, name, **over):
    shape, axes, dp, ep, sched = LAYOUTS[name]
    cfg = dataclasses.replace(cfg_p, **{"moe_dispatch": sched, **over})
    return moe.moe_dispatch(cfg, p, torch.from_numpy(x), make_mesh(shape,
                                                                   axes),
                            dp, ep)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dispatch_equals_local_with_ample_capacity(name):
    cfg_r, cfg_p, tree, lp, x = inputs()
    p = port_layer(cfg_p, tree)
    got = dispatch(cfg_p, p, x, name, capacity_factor=16.0).numpy()
    local = moe.moe_local(dataclasses.replace(cfg_p, capacity_factor=16.0),
                          p, torch.from_numpy(x)).numpy()
    ref_local = np.asarray(ref_moe.moe_local(
        dataclasses.replace(cfg_r, capacity_factor=16.0),
        jax.tree.map(jnp.asarray, lp), jnp.asarray(x)))
    assert np.abs(got - local).max() < LOCAL_TOL, name
    assert np.abs(got - ref_local).max() < LOCAL_TOL, name


def test_grid_schedule_equals_direct():
    _, cfg_p, tree, _, x = inputs()
    p = port_layer(cfg_p, tree)
    grid = dispatch(cfg_p, p, x, "grid-data2-em2-en2")
    direct = dispatch(cfg_p, p, x, "grid-data2-em2-en2",
                      moe_dispatch="direct")
    assert torch.equal(grid, direct)


def _dropped(y, full, scale):
    """Tokens whose output lost a copy: away from the no-drop output by
    more than rounding."""
    return np.nonzero(np.abs(y - full).max(-1) > 1e-3 * scale)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_dispatch_drops_what_the_reference_drops(name, reference):
    """Capacity factor 1.25: every shard sizes its capacity from its own
    8 tokens (C = 3) and drops copies; the same tokens lose a copy as in
    the reference's ``moe_dispatch``, and every output agrees within
    1e-5."""
    _, cfg_p, tree, _, x = inputs()
    p = port_layer(cfg_p, tree)
    got = dispatch(cfg_p, p, x, name).numpy()
    want = reference["y/" + name]
    assert_close(got, want, DROP_REL, name)
    full = dispatch(cfg_p, p, x, name, capacity_factor=16.0).numpy()
    scale = np.abs(full).max()
    port_drop = _dropped(got, full, scale)
    ref_drop = _dropped(want, full, scale)
    assert len(port_drop[0]) > 0, "no copy was dropped"
    for a, b in zip(port_drop, ref_drop):
        assert np.array_equal(a, b), name


def test_forward_train_through_the_dispatch_matches_reference(reference):
    """Loss and every gradient of the smoke config's ``forward_train``
    with ``moe_impl="dispatch"`` under a ``(4, 2)`` ``MeshContext``, at
    capacity factor 1.25 (drops included), against the reference's."""
    cfg_r, cfg_p, tree, _, _ = inputs()
    cfg = dataclasses.replace(cfg_p, moe_impl="dispatch")
    mesh = make_mesh((4, 2), ("data", "model"))
    ctx = model.MeshContext(mesh, ("data",), ("model",))
    assert ctx.ep_size == 2
    params = params_from_reference(cfg, tree, CPU)
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in train_inputs(cfg_r).items()}
    loss = model.forward_train(cfg, params, batch, ctx)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    want = float(reference["loss"])
    assert abs(float(loss.detach()) - want) <= F32_REL * abs(want)
    it = iter(grads)
    got = dict(_flat(params_to_reference(params.map(lambda t: next(it)))))
    for key, g in reference.items():
        if key.startswith("grad/"):
            assert_close(got[key[5:]], g, F32_REL, key)
    # the mesh moves the numbers: without it the loss differs
    local = model.forward_train(cfg, params, batch)
    assert float(local.detach()) != float(loss.detach())


def test_moe_apply_dispatches_where_the_reference_does():
    """``moe_impl="dispatch"``, a mesh context with ep_size > 1 and a
    sequence it divides: the dispatch; single-token decode, a sequence it
    does not divide, ``moe_impl="gshard"`` or no context: ``moe_local``
    (never an error)."""
    _, cfg_p, tree, _, x = inputs()
    p = port_layer(cfg_p, tree)
    cfg = dataclasses.replace(cfg_p, moe_impl="dispatch")
    mesh = make_mesh((2, 2), ("data", "model"))
    ctx = model.MeshContext(mesh, ("data",), ("model",))
    xt = torch.from_numpy(x)
    shared = swiglu(xt, p["shared_wg"], p["shared_wu"], p["shared_wd"])
    want = moe.moe_dispatch(cfg, p, xt, mesh, ("data",), ("model",)) + shared
    assert torch.equal(moe.moe_apply(cfg, p, xt, ctx), want)
    for xs, c in ((xt[:, :1], ctx), (xt[:, :3], ctx), (xt, None)):
        local = moe.moe_local(cfg, p, xs) + swiglu(
            xs, p["shared_wg"], p["shared_wu"], p["shared_wd"])
        assert torch.equal(moe.moe_apply(cfg, p, xs, c), local)
    gshard = dataclasses.replace(cfg, moe_impl="gshard")
    assert torch.equal(moe.moe_apply(gshard, p, xt, ctx),
                       moe.moe_apply(gshard, p, xt))
    # decode with the context reaches moe_apply at S = 1
    params = params_from_reference(cfg, tree, CPU)
    caches = model.init_caches(cfg, 2, 4, CPU)
    tok = torch.tensor([1, 2])
    lg, _ = model.forward_decode(cfg, params, caches, tok,
                                 torch.tensor([0, 0]), mesh_ctx=ctx)
    assert torch.isfinite(lg).all()
