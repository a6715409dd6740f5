"""The plain reference against the program at a small configuration on the
CPU, both in float32: the loss, every gradient, the prefill's logits and
its K/V.  The test imports both; the reference imports nothing of the
program."""

from __future__ import annotations


import pytest
import torch

from portbench import bench
from portbench.reference import qwen3 as ref
from portbench.tests import tiny


@pytest.fixture(scope="module")
def model():
    from repro_torch.models.api import build_model

    cfg = bench.load_cell("qwen3-1.7b.train_ckpt")["config"]
    cfg.update(tiny.TINY_MODEL, torch_dtype="float32")
    api = build_model(bench.port_config(cfg))
    params = ref.make_weights(cfg, 11, "cpu", torch.float32)
    # the norms' zero start would hide a wrong norm weight
    g = torch.Generator().manual_seed(12)
    for n in ("final_norm", "ln1", "ln2", "q_norm", "k_norm"):
        params[n] = 0.1 * torch.randn(params[n].shape, generator=g)
    return cfg, api, params


def test_weights_fill_the_programs_parameters(model):
    cfg, api, params = model
    bench.check_param_layout(api, ref.param_table(cfg))
    assert {n: tuple(p.shape) for n, p in params.items()} == {
        n: tuple(s.shape) for n, s in api.param_specs.items()}


def test_loss_and_gradients(model):
    cfg, api, params = model
    g = torch.Generator().manual_seed(13)
    ids = torch.randint(0, cfg["vocab_size"], (3, 21), generator=g)
    batch = {"tokens": ids[:, :-1], "targets": ids[:, 1:],
             "mask": torch.ones(3, 20)}
    p1 = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    loss, _ = api.loss(p1, batch)
    loss.backward()
    p2 = {n: t.clone().requires_grad_(True) for n, t in params.items()}
    want = ref.loss_sum(cfg, p2, batch) / batch["mask"].sum()
    want.backward()
    assert float(loss.detach()) == pytest.approx(float(want.detach()), rel=1e-5)
    for n in params:
        scale = p2[n].grad.abs().max()
        assert (p1[n].grad - p2[n].grad).abs().max() <= 1e-4 * scale, n


def test_prefill_logits_and_cache(model):
    cfg, api, params = model
    prompt = torch.randint(0, cfg["vocab_size"], (37,),
                           generator=torch.Generator().manual_seed(14))
    with torch.no_grad():
        logits, cache = api.prefill(params, {"tokens": prompt[None]}, 40)
    ks, vs = {}, {}
    want = ref.prefill(cfg, params, prompt,
                       on_kv=lambda i, k, v: (ks.update({i: k[0]}),
                                              vs.update({i: v[0]})))
    assert (logits[0] - want).abs().max() <= 1e-4 * want.abs().max()
    for i in range(cfg["num_hidden_layers"]):
        for got, k in ((cache["k"][i, 0, :37], ks[i]),
                       (cache["v"][i, 0, :37], vs[i])):
            assert (got - k).abs().max() <= 1e-5 * k.abs().max()


def test_adamw_matches_the_programs(model):
    from repro_torch.train.optim import AdamW

    cfg, api, params = model
    g = torch.Generator().manual_seed(15)
    grads = {n: torch.randn(p.shape, generator=g) for n, p in params.items()}
    mine = {n: p.clone() for n, p in params.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    ref.AdamW().update(mine, grads, m, v, 1e-3, 0)
    state = AdamW().init(api.param_specs)
    new, _ = AdamW().update(params, grads, state, torch.tensor(1e-3),
                            torch.tensor(0))
    for n in params:
        assert torch.allclose(new[n], mine[n], rtol=1e-6, atol=1e-9), n


def test_weights_repeat_from_the_seed():
    cfg = bench.load_cell("qwen3-4b.prefill_pool")["config"]
    cfg.update(tiny.TINY_MODEL)
    a, b = ref.make_weights(cfg, 2 ** 33 + 1, "cpu"), \
        ref.make_weights(cfg, 2 ** 33 + 1, "cpu")
    c = ref.make_weights(cfg, 2 ** 33 + 2, "cpu")
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not torch.equal(a["wq"], c["wq"])
    assert a["wq"].dtype == torch.bfloat16
    assert float(a["embed"].float().std()) == pytest.approx(0.02, rel=0.1)
