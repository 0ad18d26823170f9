"""The reference (``portbench/reference``) against the port's plain path on
``-smoke`` configurations, in float32: prompt chunks appended into the
cache, then decode steps, each step's logits against the reference's full
forward at the same position.  The test imports the port; the reference
does not."""
import dataclasses
import json

import pytest
import torch

from portbench.harness import check, runner, spec, weights
from smoke import ROOT

CHUNK = 16


def conf_of(name):
    with open(ROOT / "portbench" / "configs" / f"{name}.json") as f:
        return json.load(f)


def port_logits(cfg, params, prompt, outputs):
    from repro_torch.configs.perf import PerfConfig
    from repro_torch.models import params as P
    from repro_torch.models.lm import LM

    model = LM(cfg, PerfConfig(use_kernels=False))
    caches = P.tree_map(lambda t: t.float(), P.init(None, model.cache_specs(1, 128), "cpu"))
    got = {}
    for a in range(0, len(prompt), CHUNK):
        toks = prompt[a:a + CHUNK]
        n = len(toks)
        logits, caches = model.prefill_chunk(
            params, torch.tensor([toks + [0] * (CHUNK - n)]), torch.tensor([a]),
            torch.tensor([n]), caches)
        got[a + n - 1] = logits[0]
    pos = len(prompt)
    for t in outputs[:-1]:
        logits, caches = model.decode_step(params, torch.tensor([[t]]), torch.tensor([pos]),
                                           caches)
        got[pos] = logits[0]
        pos += 1
    return got


@pytest.mark.parametrize("name,arch,variant", [
    ("qwen2-0.5b", "qwen2-0.5b-smoke", {}),
    ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b-smoke", {}),
    # capacity drops: 16 experts, top-4, capacity factor 0.5
    ("qwen3-moe-30b-a3b", "qwen3-moe-30b-a3b-smoke",
     {"num_experts": 16, "experts_per_token": 4, "capacity_factor": 0.5}),
])
def test_reference_matches_the_port_in_f32(name, arch, variant):
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(arch), **variant)
    conf = runner.smoke_conf(conf_of(name), cfg)
    if variant:
        conf["assumed"] = dict(conf["assumed"], capacity_factor=variant["capacity_factor"])
    params = weights.draw(LM(cfg).param_specs(), 5, torch.device("cpu"))
    from repro_torch.models import params as P
    params = P.tree_map(lambda t: t.float(), params)
    g = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (40,), generator=g).tolist()
    outputs = torch.randint(0, cfg.vocab_size, (6,), generator=g).tolist()
    got = port_logits(cfg, params, prompt, outputs)
    seq = {"tokens": prompt + outputs[:-1], "first": 0,
           "segments": check.segments(len(prompt), 0, len(outputs), CHUNK)}
    ref = spec.reference(conf["family"])
    want = next(ref.forward(params, conf, [seq]))
    scale = want.abs().max()
    for pos, logits in got.items():
        assert (logits - want[pos]).abs().max() <= 1e-4 * scale, pos
    if variant:
        # the variant drops: the reference's mask is not all kept
        from portbench.reference import moe
        idx = torch.topk(torch.rand(40, 16, generator=g), 4, dim=-1).indices
        assert not moe.keep_mask(idx, seq["segments"], 16, 0.5).all()


def test_control_rounds_to_float8():
    from portbench.reference import decoder
    x = torch.randn(4, 64)
    y = decoder.fp8(x)
    rel = ((y - x).abs() / x.abs().amax(-1, keepdim=True)).max()
    assert 0 < rel < 2 ** -4
