"""The LM serving engine (``repro_torch.serve.engine``) and its launcher
(``repro_torch.launch.serve``), in process, on the CPU.

The reference's four scenarios (``tests/test_serve.py``: completion,
the declared ``_pending`` field, the empty-prompt rejection with FIFO
admission, greedy serving equal to a manual decode) run on the port.
Then the port's greedy engine is held to the reference's token for token
on the llama3.2 and qwen2 smoke configs in float32, both engines on the
same parameters (the reference's layout filled from numpy, carried over
by ``params_from_reference``), with prompts of one to four tokens, slot
refills and a request cut by ``max_len``.  Temperature sampling is
seeded by a ``torch.Generator``, so it is held to itself, not to
``jax.random``.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.engine as ref_engine
from repro_torch.launch import serve as launcher
from repro_torch.models import model
from repro_torch.models.convert import params_from_reference
from repro_torch.serve.engine import Request, ServeEngine
from tests.test_torch_models import configs, numpy_tree

# small tensors beside other busy workers: more threads only spin
torch.set_num_threads(1)

CPU = "cpu"


def _port(arch, seed=0, **over):
    over.setdefault("dtype", "bfloat16")
    _, cfg = configs(arch, **over)
    return cfg, model.init_params(cfg, torch.Generator().manual_seed(seed),
                                  CPU)


def test_engine_completes_requests():
    cfg, params = _port("qwen2-1.5b")
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=64, device=CPU)
    reqs = [Request(rid=i, prompt=[1 + i, 2 + i, 3 + i], max_new=5)
            for i in range(5)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done
        assert len(r.out) == 5
        assert all(0 <= t < cfg.vocab_size for t in r.out)


def test_request_pending_is_declared_field():
    names = {f.name for f in dataclasses.fields(Request)}
    assert "_pending" in names
    r = Request(rid=0, prompt=[1, 2])
    assert r._pending == []
    assert dataclasses.replace(r, rid=1)._pending == []


def test_engine_rejects_empty_prompt_and_admits_fifo():
    cfg, params = _port("qwen2-1.5b")
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=32, device=CPU)
    assert isinstance(eng.queue, collections.deque)
    with pytest.raises(ValueError, match="empty prompt"):
        eng.submit(Request(rid=9, prompt=[]))
    assert not eng.queue
    reqs = [Request(rid=i, prompt=[i + 1], max_new=2) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    assert [r.rid for r in eng.queue] == [0, 1, 2]
    eng.run()
    assert all(r.done and len(r.out) == 2 for r in reqs)


def test_engine_greedy_matches_manual_decode():
    cfg, params = _port("llama3.2-3b", seed=1)
    prompt = [5, 9, 2]
    eng = ServeEngine(cfg, params, batch_slots=1, max_len=32, device=CPU)
    r = Request(rid=0, prompt=list(prompt), max_new=4)
    eng.submit(r)
    eng.run()
    caches = model.init_caches(cfg, 1, 32, CPU)
    pos = 0
    logits = None
    for t in prompt:
        logits, caches = model.forward_decode(
            cfg, params, caches, torch.tensor([t]), torch.tensor([pos]))
        pos += 1
    out = []
    for _ in range(4):
        nxt = int(logits[0].float().argmax())
        out.append(nxt)
        logits, caches = model.forward_decode(
            cfg, params, caches, torch.tensor([nxt]), torch.tensor([pos]))
        pos += 1
    assert r.out == out, (r.out, out)


def _requests(request_cls, vocab):
    rng = np.random.default_rng(11)
    reqs = [request_cls(rid=i, prompt=[int(t) for t in rng.integers(
        1, vocab, 1 + i % 4)], max_new=5) for i in range(5)]
    # cut by max_len: its slot retires at pos T - 1, not at max_new
    reqs.append(request_cls(rid=5, prompt=[3, 1, 4], max_new=40))
    return reqs


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-1.5b"])
def test_greedy_tokens_equal_reference(arch):
    cfg_r, cfg_p = configs(arch)
    tree = numpy_tree(cfg_r, 2)
    params = params_from_reference(cfg_p, tree, CPU)
    ref = ref_engine.ServeEngine(cfg_r, jax.tree.map(jnp.asarray, tree),
                                 batch_slots=2, max_len=16)
    port = ServeEngine(cfg_p, params, batch_slots=2, max_len=16, device=CPU)
    ref_reqs = _requests(ref_engine.Request, cfg_r.vocab_size)
    port_reqs = _requests(Request, cfg_p.vocab_size)
    for eng, reqs in ((ref, ref_reqs), (port, port_reqs)):
        for r in reqs:
            eng.submit(r)
        eng.run()
    assert [r.out for r in port_reqs] == [r.out for r in ref_reqs]
    assert all(r.done for r in port_reqs)
    assert len(port_reqs[-1].out) < 40  # retired by max_len


def test_temperature_sampling_is_seeded():
    cfg, params = _port("llama3.2-3b", dtype="float32")

    def serve(seed):
        eng = ServeEngine(cfg, params, batch_slots=2, max_len=32,
                          temperature=0.8, seed=seed, device=CPU)
        reqs = [Request(rid=i, prompt=[i + 1, 7], max_new=8)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.out for r in reqs]

    first = serve(0)
    assert serve(0) == first
    assert serve(1) != first
    assert all(0 <= t < cfg.vocab_size for out in first for t in out)


def test_launcher_smoke_on_the_cpu(capsys):
    res = launcher.main(["--arch", "qwen2-1.5b", "--smoke", "--device",
                         "cpu", "--requests", "3", "--max-new", "4",
                         "--slots", "2"])
    assert res["done"] and res["tokens"] == 12 and res["requests"] == 3
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out and "device=cpu" in out
    res = launcher.main(["--arch", "llama3.2-3b", "--smoke", "--device",
                         "cpu", "--requests", "2", "--max-new", "3",
                         "--int8-kv"])
    assert res["done"] and "kv=int8" in capsys.readouterr().out


def test_engine_and_launcher_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, params = _port("qwen2-1.5b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(["--arch", "qwen2-1.5b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init_params(cfg, torch.Generator())
    with pytest.raises(ValueError, match="parameters are on"):
        ServeEngine(cfg, params.to("meta"), device=CPU)
