"""LM training in the port (``repro_torch.models.model: forward_train``,
``repro_torch.train``, ``repro_torch.models.sharding``,
``repro_torch.launch.{mesh,train}``) against the JAX reference, in
process, on the CPU.

Parameters: the reference's layout filled from ``default_rng``
(``tests/test_torch_models.py: numpy_tree``), fed to both packages.
``forward_train``'s loss and every gradient of all ten smoke configs in
float32 are held to ``jax.value_and_grad`` of the reference (1e-4
relative, each gradient against its leaf's largest reference magnitude),
under both remat policies; the reference runs once per arch
(``reference_grads``; its remat policy changes no number).  Then AdamW
and its schedule, one train step with 1 and 4 microbatches, the
reference's own ``tests/test_train.py`` cases on the port, int8
compression bit for bit, checkpoints across the two packages in both
directions (manifests and files byte for byte), the partition specs of
all ten published configs on the production meshes, and the launcher.
"""
import dataclasses
import gc
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs.base as ref_configs
import repro.models.model as ref_model
import repro.models.sharding as ref_shd
import repro.train.checkpoint as ref_ckpt
import repro.train.compression as ref_comp
import repro.train.optimizer as ref_opt
import repro.train.train_loop as ref_loop
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import model, sharding
from repro_torch.models.convert import (opt_state_from_reference,
                                        opt_state_to_reference,
                                        params_from_reference,
                                        params_to_reference)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import compression
from repro_torch.train.optimizer import (AdamWConfig, apply_update,
                                         init_state, schedule, zero1_specs)
from repro_torch.train.train_loop import (TrainConfig, make_train_step,
                                          setup_sharded, train)
from tests.test_torch_models import (ARCHS, CPU, F32_REL, assert_close,
                                     configs, numpy_tree)

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

B, S = 2, 8
OPT_REL = 1e-6   # AdamW and its schedule on the same inputs (fp32)


def train_batch(cfg, B=B, S=S, seed=1):
    """Tokens and next-token labels from ``default_rng(seed)``, the first
    two labels of row 0 masked (-1), and the frontend stubs."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :S].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][0, :2] = -1
    if cfg.frontend == "patch":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    if cfg.frontend == "audio":
        batch["frames"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


def tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def leaves(tree, prefix=()):
    """(path, array) of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def assert_trees_close(got, ref, rel, what):
    g = dict(leaves(got))
    r = dict(leaves(ref))
    assert list(g) == list(r) or sorted(g) == sorted(r), what
    for path, rv in r.items():
        assert_close(g[path], rv, rel, f"{what} {path}")


@pytest.fixture(scope="module")
def reference_grads():
    """arch -> the reference's tree, batch, loss and grads (numpy),
    computed once per module."""
    memo = {}

    def run(arch):
        if arch not in memo:
            cfg, _ = configs(arch)
            tree = numpy_tree(cfg, 0)
            batch = train_batch(cfg)
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: ref_model.forward_train(cfg, p, b)))
            loss, grads = fn(tree, batch)
            memo[arch] = dict(tree=tree, batch=batch, loss=float(loss),
                              grads=jax.tree.map(np.asarray, grads))
        return memo[arch]
    return run


def port_grads(arch, ref, **over):
    _, cfg = configs(arch, **over)
    params = params_from_reference(cfg, ref["tree"], CPU)
    params.requires_grad_(True)
    loss = model.forward_train(cfg, params, tensors(ref["batch"]))
    grads = torch.autograd.grad(loss, list(params.parameters()),
                                allow_unused=True, materialize_grads=True)
    it = iter(grads)
    return float(loss.detach()), params_to_reference(
        params.map(lambda p: next(it)))


# ---------------------------------------------------------------------------
# forward_train and its gradients, every arch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_reference(arch, reference_grads):
    ref = reference_grads(arch)
    loss, grads = port_grads(arch, ref)
    assert np.isfinite(loss)
    assert abs(loss - ref["loss"]) <= F32_REL * abs(ref["loss"]), \
        (loss, ref["loss"])
    assert_trees_close(grads, ref["grads"], F32_REL, f"{arch} grad")


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_remat_matches_reference(arch, reference_grads):
    """``remat_policy="dots"``: the reference's numbers within 1e-4, and
    the port's own ``"none"`` run bit for bit (remat moves memory, never
    numbers)."""
    ref = reference_grads(arch)
    loss, grads = port_grads(arch, ref, remat_policy="dots")
    assert abs(loss - ref["loss"]) <= F32_REL * abs(ref["loss"])
    assert_trees_close(grads, ref["grads"], F32_REL, f"{arch} dots grad")
    loss0, grads0 = port_grads(arch, ref)
    assert loss == loss0
    for path, g in leaves(grads0):
        assert np.array_equal(dict(leaves(grads))[path], g), path


class _CountProducts(TorchDispatchMode):
    """Dispatched products: the ones ``"dots"`` saves (mm, addmm) and
    the batched ones (bmm)."""
    def __init__(self):
        super().__init__()
        self.saved = self.batched = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.saved += func in model._DOTS
        self.batched += func is torch.ops.aten.bmm.default
        return func(*args, **(kwargs or {}))


def _backward_products(policy):
    """(mm + addmm, bmm) dispatched by the backward pass of the llama
    smoke config under ``policy``."""
    _, cfg = configs("llama3.2-3b", remat_policy=policy)
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    params.requires_grad_(True)
    loss = model.forward_train(cfg, params, tensors(train_batch(cfg)))
    with _CountProducts() as c:
        torch.autograd.grad(loss, list(params.parameters()))
    return c.saved, c.batched


def test_dots_policy_saves_the_unbatched_products(monkeypatch):
    """Under ``"dots"`` the backward pass recomputes no product without
    batch dims (as many mm/addmm as a backward pass with no
    checkpointing at all) and recomputes the batched ones (attention
    scores and values), as the reference's
    ``dots_with_no_batch_dims_saveable``; under ``"none"`` it recomputes
    both."""
    none, dots = _backward_products("none"), _backward_products("dots")
    monkeypatch.setattr(model, "_call", lambda remat, fn, *a: fn(*a))
    plain = _backward_products("none")
    assert dots[0] == plain[0] < none[0], (none, dots, plain)
    assert plain[1] < dots[1] == none[1], (none, dots, plain)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _opt_inputs(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": (7,), "c": {"d": (2, 2, 4)}}

    def fill(shape, scale):
        if isinstance(shape, dict):
            return {k: fill(v, scale) for k, v in shape.items()}
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    return fill(shapes, 1.0), fill(shapes, 0.3), fill(shapes, 0.01)


def _port_tree(tree):
    def conv(t):
        return {k: conv(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v)) for k, v in t.items()}
    return model.Params(conv(tree))


@pytest.mark.parametrize("grad_scale", [0.3, 30.0])  # unclipped, clipped
def test_apply_update_matches_reference(grad_scale):
    params, grads, mom = _opt_inputs(2)
    cfg = AdamWConfig(lr=1e-2, warmup_steps=3, total_steps=20)
    ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    r_params, r_state = params, ref_opt.AdamWState(
        jnp.int32(4), mom, jax.tree.map(np.abs, mom))
    p_params = _port_tree(params)
    p_state = opt_state_from_reference(r_state, CPU)
    for t in range(3):   # steps 5-7: warm-up ends, decay starts
        g = jax.tree.map(lambda x: grad_scale * (x + t), grads)
        r_params, r_state = ref_opt.apply_update(ref_cfg, r_params, g,
                                                 r_state)
        p_params, p_state = apply_update(cfg, p_params, _port_tree(g),
                                         p_state)
    assert int(p_state.step) == int(r_state.step) == 7
    assert_trees_close(params_to_reference(p_params),
                       jax.tree.map(np.asarray, r_params), OPT_REL, "params")
    got = opt_state_to_reference(p_state)
    assert_trees_close(got.mu, jax.tree.map(np.asarray, r_state.mu),
                       OPT_REL, "mu")
    assert_trees_close(got.nu, jax.tree.map(np.asarray, r_state.nu),
                       OPT_REL, "nu")


def test_schedule_matches_reference():
    cfg = AdamWConfig(lr=3e-4, warmup_steps=100, total_steps=10_000)
    ref_cfg = ref_opt.AdamWConfig(**dataclasses.asdict(cfg))
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        got = float(schedule(cfg, torch.tensor(step, dtype=torch.int32)))
        want = float(ref_opt.schedule(ref_cfg, jnp.int32(step)))
        assert abs(got - want) <= OPT_REL * abs(want) + 1e-12, (step, got,
                                                                  want)


def test_adamw_direction():
    params = _port_tree({"w": np.array([1.0, -1.0], np.float32)})
    grads = _port_tree({"w": np.array([0.5, -0.5], np.float32)})
    st = init_state(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                      total_steps=10)
    p2, st2 = apply_update(cfg, params, grads, st)
    # moves against the gradient
    assert float(p2["w"][0]) < 1.0 and float(p2["w"][1]) > -1.0
    assert int(st2.step) == 1


# ---------------------------------------------------------------------------
# one train step against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 4])
def test_train_step_matches_reference(microbatches):
    cfg_r, cfg_p = configs("llama3.2-3b")
    tree = numpy_tree(cfg_r, 3)
    batch = train_batch(cfg_r, B=8, seed=4)
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    tc = TrainConfig(opt=opt, microbatches=microbatches)
    ref_tc = ref_loop.TrainConfig(
        opt=ref_opt.AdamWConfig(**dataclasses.asdict(opt)),
        microbatches=microbatches)
    r_params, r_state, r_m = jax.jit(ref_loop.make_train_step(cfg_r, ref_tc))(
        tree, ref_opt.init_state(tree), batch)
    params = params_from_reference(cfg_p, tree, CPU)
    p_params, p_state, p_m = make_train_step(cfg_p, tc)(
        params, init_state(params), tensors(batch))

    assert int(p_m["step"]) == int(r_m["step"]) == 1
    assert abs(float(p_m["loss"]) - float(r_m["loss"])) <= \
        F32_REL * abs(float(r_m["loss"]))
    got = opt_state_to_reference(p_state)
    r_mu = jax.tree.map(np.asarray, r_state.mu)
    # after one step from zero moments mu = (1 - b1) * clip * g: the
    # (clipped) gradients, compared through mu
    assert_trees_close(got.mu, r_mu, F32_REL, "mu")
    assert_trees_close(got.nu, jax.tree.map(np.asarray, r_state.nu),
                       F32_REL, "nu")
    lr = float(ref_opt.schedule(ref_tc.opt, jnp.int32(1)))
    p_new = dict(leaves(params_to_reference(p_params)))
    for path, want in leaves(jax.tree.map(np.asarray, r_params)):
        g_ref = dict(leaves(r_mu))[path] / (1 - opt.b1)
        diff = np.abs(p_new[path] - want)
        big = np.abs(g_ref) >= 1e-6
        # where the gradient vanishes AdamW's first step takes its sign
        assert (diff[big] <= 1e-4 * lr).all(), (path, diff[big].max())
        assert (diff[~big] <= 2 * lr).all(), path


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_leaves_no_tensor_in_a_reference_cycle(microbatches):
    """A step's gradients and activations are freed when it returns, not
    when the garbage collector next runs: at full width they are 7 GB
    (a reference cycle around them raised phase 10a's peak by that)."""
    _, cfg = configs("llama3.2-3b")
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    state = init_state(params)
    step = make_train_step(cfg, TrainConfig(microbatches=microbatches))
    batch = tensors(train_batch(cfg))
    params, state, _ = step(params, state, batch)
    gc.collect()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        params, state, _ = step(params, state, batch)
        gc.collect()
        leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
    assert not leaked, [tuple(t.shape) for t in leaked]


# ---------------------------------------------------------------------------
# the reference's tests/test_train.py on the port
# ---------------------------------------------------------------------------

def _data_iter(cfg, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    # a learnable synthetic task: token t+1 = (t * 3 + 1) % V
    V = cfg.vocab_size
    while True:
        t0 = rng.integers(0, V, (B, 1))
        seq = [t0]
        for _ in range(S):
            seq.append((seq[-1] * 3 + 1) % V)
        arr = np.concatenate(seq, axis=1)
        yield {"tokens": torch.from_numpy(arr[:, :S]),
               "labels": torch.from_numpy(arr[:, 1:S + 1])}


def test_loss_decreases():
    cfg = configs("llama3.2-3b", dtype="bfloat16")[1]
    tc = TrainConfig(opt=AdamWConfig(lr=1e-2, warmup_steps=5,
                                     total_steps=80))
    res = train(cfg, tc, _data_iter(cfg), num_steps=60,
                log=lambda *_: None, device=CPU)
    assert res["losses"][-1] < res["losses"][0] * 0.7, res["losses"]


def test_grad_accum_equivalence():
    cfg = configs("qwen2-1.5b", dtype="bfloat16")[1]
    batch = next(_data_iter(cfg, B=8))
    out = {}
    for mb in (1, 4):
        params = model.init_params(cfg, torch.Generator().manual_seed(0),
                                   CPU)
        tc = TrainConfig(opt=AdamWConfig(lr=1e-3), microbatches=mb)
        out[mb] = make_train_step(cfg, tc)(params, init_state(params), batch)
    (p1, _, m1), (p4, _, m4) = out[1], out[4]
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    # parameters after one step agree to bf16-accumulation tolerance
    d = max(float(torch.max(torch.abs(a.float() - b.float())))
            for a, b in zip(p1.parameters(), p4.parameters()))
    assert d < 5e-2, d


def test_checkpoint_restart(tmp_path):
    cfg = configs("llama3.2-3b", dtype="bfloat16")[1]
    ckdir = str(tmp_path / "ck")
    tc = TrainConfig(opt=AdamWConfig(lr=5e-3), ckpt_dir=ckdir, ckpt_every=5,
                     log_every=100)
    train(cfg, tc, _data_iter(cfg), num_steps=10, log=lambda *_: None,
          device=CPU)
    # "crash" and resume: the loop must pick up at step 10
    logs = []
    r2 = train(cfg, tc, _data_iter(cfg), num_steps=20, log=logs.append,
               device=CPU)
    assert logs[0] == "[train] resumed from step 10"
    tc_clean = TrainConfig(opt=AdamWConfig(lr=5e-3),
                           ckpt_dir=str(tmp_path / "clean"), ckpt_every=50,
                           log_every=100)
    r3 = train(cfg, tc_clean, _data_iter(cfg), num_steps=20,
               log=lambda *_: None, device=CPU)
    # the data stream restarts from its beginning in run 2, so exact
    # equality is not expected, but shapes and values are sane
    for a, b in zip(r2["params"].parameters(), r3["params"].parameters()):
        assert a.shape == b.shape
    assert np.isfinite(r2["losses"][-1])
    assert int(r2["opt_state"].step) == 20
    assert ckpt.latest_step(ckdir) == 20


def test_checkpoint_corruption_detected(tmp_path):
    cfg = configs("qwen2-1.5b", dtype="bfloat16")[1]
    params = model.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    tree = {"params": params}
    ckpt.save(str(tmp_path), 5, tree)
    ckpt.save(str(tmp_path), 10, tree)
    assert ckpt.latest_step(str(tmp_path)) == 10
    # corrupt the newest: delete a leaf file -> restore must fall back
    d = os.path.join(str(tmp_path), "step_0000000010")
    victim = [f for f in os.listdir(d) if f.endswith(".npy")][0]
    os.remove(os.path.join(d, victim))
    assert ckpt.latest_step(str(tmp_path)) == 5
    restored = ckpt.restore(str(tmp_path), 5, tree, verify=True)
    for a, b in zip(restored["params"].parameters(), params.parameters()):
        assert torch.equal(a, b)


def test_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(333,)).astype(np.float32))}
    r = compression.init_residual(g)
    total = np.zeros(333, np.float32)
    sent_total = np.zeros(333, np.float32)
    for _ in range(50):
        sent, r = compression.compress_with_feedback(g, r)
        total += g["w"].numpy()
        sent_total += sent["w"].numpy()
    # error feedback: the long-run average of the sent gradients converges
    # to the true gradient (the residual stays bounded)
    np.testing.assert_allclose(sent_total / 50, total / 50, atol=1e-2)
    assert float(torch.max(torch.abs(r["w"]))) < 0.1


# ---------------------------------------------------------------------------
# compression, bit for bit
# ---------------------------------------------------------------------------

def _compression_inputs():
    rng = np.random.default_rng(5)
    half = np.zeros(256, np.float32)
    half[:5] = [127.0, 0.5, 1.5, 2.5, -2.5]   # x/scale on the half-way
    return {"a": rng.standard_normal((333,)).astype(np.float32),
            "b": (1e-3 * rng.standard_normal((4, 300))).astype(np.float32),
            "h": half, "z": np.zeros((5,), np.float32)}


def test_quantize_int8_bit_for_bit():
    for name, x in _compression_inputs().items():
        for block in (256, 64):
            rq, rs = ref_comp.quantize_int8(jnp.asarray(x), block)
            pq, ps = compression.quantize_int8(torch.from_numpy(x), block)
            assert pq.dtype == torch.int8 and ps.dtype == torch.float32
            assert np.array_equal(pq.numpy(), np.asarray(rq)), name
            assert np.array_equal(ps.numpy(), np.asarray(rs)), name
            back = compression.dequantize_int8(pq, ps, x.shape,
                                               torch.float32)
            want = ref_comp.dequantize_int8(rq, rs, x.shape, jnp.float32)
            assert np.array_equal(back.numpy(), np.asarray(want)), name


def test_compress_with_feedback_bit_for_bit():
    grads = _compression_inputs()
    r_res = ref_comp.init_residual(grads)
    p_res = compression.init_residual({k: torch.from_numpy(v)
                                       for k, v in grads.items()})
    for t in range(3):
        g = {k: v * (t + 1) for k, v in grads.items()}
        r_sent, r_res = ref_comp.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), r_res)
        p_sent, p_res = compression.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, p_res)
        for k in grads:
            assert np.array_equal(p_sent[k].numpy(), np.asarray(r_sent[k]))
            assert np.array_equal(p_res[k].numpy(), np.asarray(r_res[k]))
    # on a Params tree too
    tree = _port_tree(grads)
    sent, res = compression.compress_with_feedback(
        tree, compression.init_residual(tree))
    assert isinstance(sent, model.Params) and isinstance(res, model.Params)
    assert np.array_equal(sent["a"].numpy(), np.asarray(
        ref_comp.compress_with_feedback(
            {"a": jnp.asarray(grads["a"])},
            {"a": jnp.zeros(333, jnp.float32)})[0]["a"]))


# ---------------------------------------------------------------------------
# checkpoints across the two packages
# ---------------------------------------------------------------------------

def _trained_state(cfg_r, cfg_p):
    """The llama smoke tree (bf16) after one port train step: the
    parameters, and moments that are not zero."""
    tree = numpy_tree(cfg_r, 7)
    params = params_from_reference(cfg_p, tree, CPU)
    params, state, _ = make_train_step(cfg_p, TrainConfig())(
        params, init_state(params), tensors(train_batch(cfg_r, seed=8)))
    return params, state


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _files_equal(a, b):
    m = _manifest(a)
    assert m == _manifest(b)
    for meta in m["leaves"].values():
        with open(os.path.join(a, meta["file"]), "rb") as fa, \
                open(os.path.join(b, meta["file"]), "rb") as fb:
            assert fa.read() == fb.read(), meta["file"]
    return m


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    cfg_r, cfg_p = configs("llama3.2-3b", dtype="bfloat16")
    params, state = _trained_state(cfg_r, cfg_p)
    port_dir = ckpt.save(str(tmp_path / "port"), 1,
                         {"params": params, "opt": state})
    like = {"params": jax.tree.map(jnp.asarray, numpy_tree(cfg_r, 0)),
            "opt": ref_opt.init_state(numpy_tree(cfg_r, 0))}
    restored = ref_ckpt.restore(str(tmp_path / "port"), 1, like,
                                verify=True)
    want_p = dict(leaves(params_to_reference(params)))
    for path, arr in leaves(jax.tree.map(np.asarray, restored["params"])):
        assert arr.dtype == ml_dtypes.bfloat16, path
        assert np.array_equal(arr.view(np.uint16), want_p[path])
    want_o = opt_state_to_reference(state)
    assert int(restored["opt"].step) == 1
    for name in ("mu", "nu"):
        got = jax.tree.map(np.asarray, getattr(restored["opt"], name))
        for path, arr in leaves(got):
            assert np.array_equal(arr, dict(leaves(getattr(want_o, name)))
                                  [path])
    # the reference writes the same tree back: manifest and files equal
    ref_dir = ref_ckpt.save(str(tmp_path / "ref"), 1, restored)
    m = _files_equal(port_dir, ref_dir)
    assert len(m["leaves"]) == 37
    assert m["leaves"]["params/blocks/attn/wq"]["shape"] == [2, 64, 4, 16]
    assert m["leaves"]["params/blocks/attn/wq"]["dtype"] == "bfloat16"
    assert m["leaves"]["opt/.step"] == {
        **m["leaves"]["opt/.step"], "shape": [], "dtype": "int32"}


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    cfg_r, cfg_p = configs("llama3.2-3b", dtype="bfloat16")
    tree = numpy_tree(cfg_r, 9)
    rng = np.random.default_rng(10)
    moments = lambda: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    ref_state = ref_opt.AdamWState(np.int32(6), moments(), moments())
    ref_dir = ref_ckpt.save(str(tmp_path / "ref"), 6,
                            {"params": tree, "opt": ref_state})
    params = model.init_params(cfg_p, torch.Generator().manual_seed(0), CPU)
    like = {"params": params, "opt": init_state(params)}
    assert ckpt.latest_step(str(tmp_path / "ref")) == 6
    got = ckpt.restore(str(tmp_path / "ref"), 6, like, verify=True)
    assert isinstance(got["params"], model.Params)
    assert got["params"]["blocks"][1]["attn"]["wq"].dtype == torch.bfloat16
    want = params_to_reference(
        params_from_reference(cfg_p, tree, CPU))
    for path, arr in leaves(params_to_reference(got["params"])):
        assert np.array_equal(arr, dict(leaves(want))[path]), path
    o = opt_state_to_reference(got["opt"])
    assert int(o.step) == 6
    for name in ("mu", "nu"):
        for path, arr in leaves(getattr(o, name)):
            assert np.array_equal(arr, dict(leaves(getattr(ref_state, name)))
                                  [path]), path
    port_dir = ckpt.save(str(tmp_path / "port"), 6, got)
    _files_equal(port_dir, ref_dir)
    # a flipped byte fails verification in the port as in the reference
    victim = _manifest(port_dir)["leaves"]["params/embed"]["file"]
    arr = np.load(os.path.join(port_dir, victim))
    arr.reshape(-1)[0] ^= 1
    np.save(os.path.join(port_dir, victim), arr)
    with pytest.raises(ValueError, match="checksum"):
        ckpt.restore(str(tmp_path / "port"), 6, like, verify=True)


# ---------------------------------------------------------------------------
# partition specs on the production meshes
# ---------------------------------------------------------------------------

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model"))]


def _ref_shapes(cfg):
    return jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                          jax.random.key(0))


def _by_path(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(p.key for p in path): v for path, v in flat}


def test_production_meshes():
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        shape, axes = MESHES[int(multi)]
        assert mesh.axis_names == axes and tuple(mesh.shape.values()) == shape


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_moment_specs_equal_reference(arch):
    shapes = _ref_shapes(ref_configs.get_arch(arch).config)
    by_path = {p: tuple(s.shape) for p, s in _by_path(shapes).items()}
    want = {p: tuple(s) for p, s in _by_path(ref_shd.param_specs(shapes))
            .items()}
    assert sharding.param_specs(by_path) == want
    for dims, axes in MESHES:
        ref_mesh = AbstractMesh(dims, axes)
        mesh = make_mesh(dims, axes)
        ref_valid = ref_shd.valid_param_specs(shapes, ref_mesh)
        valid = sharding.valid_param_specs(by_path, mesh)
        assert valid == {p: tuple(s) for p, s in _by_path(ref_valid).items()}
        ref_z = ref_opt.zero1_specs(ref_valid, shapes, ref_mesh)
        assert zero1_specs(valid, by_path, mesh) == \
            {p: tuple(s) for p, s in _by_path(ref_z).items()}
        assert sharding.data_axes(mesh) == ref_shd.data_axes(ref_mesh)
        for fn in ("batch_spec", "cache_spec", "activation_spec"):
            assert getattr(sharding, fn)(mesh) == \
                tuple(getattr(ref_shd, fn)(ref_mesh)), fn


@pytest.mark.parametrize("arch", ["deepseek-v2-236b", "zamba2-1.2b",
                                  "whisper-small"])
def test_specs_of_a_port_tree(arch):
    """A port ``Params`` tree (one tree a layer) gets the specs of the
    reference's stacked tree; ``setup_sharded`` returns them for its mesh
    with ``("model",)`` as the expert axes."""
    cfg_r, cfg_p = configs(arch)
    shapes = _ref_shapes(cfg_r)
    ref_mesh = AbstractMesh((4, 2), ("data", "model"))
    mesh = make_mesh((4, 2), ("data", "model"))
    _, state, step, ctx, specs = setup_sharded(cfg_p, mesh, TrainConfig(),
                                               device=CPU)
    want = {p: tuple(s) for p, s in
            _by_path(ref_shd.valid_param_specs(shapes, ref_mesh)).items()}
    assert specs["params"] == want
    assert ctx.dp_axes == ("data",) and ctx.ep_axes == ("model",)
    assert ctx.ep_size == 2
    assert specs["opt"].mu == {p: tuple(s) for p, s in _by_path(
        ref_opt.zero1_specs(ref_shd.valid_param_specs(shapes, ref_mesh),
                            shapes, ref_mesh)).items()}


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-1.5b", "--steps", "4"],
    ["--arch", "internvl2-76b", "--steps", "2", "--microbatches", "2"],
    ["--arch", "deepseek-v2-236b", "--steps", "2", "--mesh", "2x2"],
])
def test_launcher_smoke_on_cpu(argv, capsys, tmp_path):
    res = launcher.main(argv + ["--smoke", "--batch", "2", "--seq", "8",
                                "--device", "cpu", "--ckpt",
                                str(tmp_path)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"done: final loss {res['losses'][-1]:.4f}"
    assert np.isfinite(res["losses"][-1])
    steps = int(argv[argv.index("--steps") + 1])
    assert ckpt.latest_step(str(tmp_path)) == steps
