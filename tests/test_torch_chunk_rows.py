"""The paged chunk call's shape on the CPU: the engine runs
``prefill_chunk_paged`` over the rows that advance a prompt, in ascending
order, and the block-table columns up to the furthest position the call
writes.  A compact call gives the live rows of a pool-wide call their
logits and the pools their contents (qwen2 and a capacity-dropping MoE, on
f32 pools); an engine whose call is expanded back to the pool-wide one
samples the same tokens under a seeded, non-greedy sampler."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.perf import BASELINE
from repro_torch.models import params as P
from repro_torch.models.lm import make_model
from repro_torch.serving import InferenceEngine, Request, SamplingParams

F32 = dataclasses.replace(BASELINE, kv_dtype="float32")
KW = dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8, device="cpu")
# 16 experts, top-4, capacity factor 0.5: a chunk row drops assignments
DROPPING = dict(num_experts=16, experts_per_token=4, capacity_factor=0.5)
ARCHS = {"qwen2": ("qwen2-0.5b-smoke", {}),
         "moe-dropping": ("qwen3-moe-30b-a3b-smoke", DROPPING)}


def _cfg(name):
    arch, over = ARCHS[name]
    return dataclasses.replace(get_config(arch), **over)


def _f32_params(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return P.tree_map(lambda a: a.float(), P.init(gen, model.param_specs(), "cpu"))


def _prompts(vocab, seed=1):
    """Staggered prompts: chunked ones, short ones, and two that share a
    19-token prefix, the second submitted after the first has retired (a
    prefix hit on a partial tail block: copy-on-write)."""
    rng = np.random.default_rng(seed)

    def toks(n):
        return [int(x) for x in rng.integers(0, vocab, n)]

    shared = toks(19)
    wave1 = [toks(40), toks(5), shared + toks(4), toks(33), toks(11)]
    wave2 = [shared + toks(9), toks(27), shared + toks(2)]
    return wave1, wave2


def _serve(eng, sampling, seed=1):
    wave1, wave2 = _prompts(eng.cfg.vocab_size, seed)
    for i, p in enumerate(wave1):
        eng.submit(Request(rid=i, prompt=p, sampling=sampling()), now=float(i))
    t, sent = 10.0, False
    while eng.pending() or not sent:
        if not eng.pending():
            for i, p in enumerate(wave2):
                eng.submit(Request(rid=100 + i, prompt=p, sampling=sampling()), now=t)
            sent = True
        eng.step(now=t)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_the_chunk_call_covers_its_rows_and_their_blocks(arch):
    cfg = _cfg(arch)
    eng = InferenceEngine(cfg, kv_backend="paged", **KW)
    real = eng.model.prefill_chunk_paged
    calls = []

    def spy(params, tokens, pos0, n_valid, pools, table):
        # no budget: every row mid-prefill advances in this call
        rows = sorted(eng._prefilling)
        calls.append((tuple(tokens.shape), tuple(table.shape), len(rows)))
        ends = (pos0 + n_valid).tolist()
        assert (n_valid > 0).all()
        assert ends == [int(eng.pos[r]) for r in rows]
        assert table.shape[1] == math.ceil(max(ends) / eng.block_size)
        assert torch.equal(table, torch.as_tensor(eng.block_tables[rows, :table.shape[1]]))
        return real(params, tokens, pos0, n_valid, pools, table)

    eng.model.prefill_chunk_paged = spy
    sizes = []
    wave1, wave2 = _prompts(cfg.vocab_size)
    for i, p in enumerate(wave1 + wave2):
        eng.submit(Request(rid=i, prompt=p, sampling=SamplingParams(max_new_tokens=4)),
                   now=float(i))
    t = 10.0
    while eng.pending():
        n = len(calls)
        st = eng.step(now=t)
        t += 1.0
        assert len(calls) - n == int(st.chunk_rows > 0)
        if st.chunk_rows:
            (batch, width), (tbl_rows, n_blk), n_rows = calls[-1]
            assert batch == tbl_rows == n_rows == st.chunk_rows
            assert width == eng.chunk
            sizes.append((batch, n_blk))
    # the calls vary in rows and in columns, and none spans the whole pool
    assert len({b for b, _ in sizes}) > 1 and len({c for _, c in sizes}) > 1
    assert min(c for _, c in sizes) < eng.max_blk


def _pool_setup(cfg, C=16, bs=8, max_len=64):
    """Pools after a first call has written row 1's first chunk, row 3's
    whole prompt, and row 1's first 12 positions again for row 2 (whose
    table shares row 1's first block and holds a copy of its second: a
    prefix hit of 12 tokens, copied on write).  Returns the model, params,
    pools, the full table and the second call's inputs: row 0 fresh at 0,
    row 1 mid-prompt at 16, row 2 at 12 after its hit, row 3 idle."""
    model = make_model(cfg, F32)
    params = _f32_params(model)
    max_blk = max_len // bs
    B = 4
    pools = P.init(None, model.paged_cache_specs(B * max_blk + 1, bs), "cpu")
    table = torch.full((B, max_blk), -1, dtype=torch.int32)
    for r in range(B):
        table[r] = torch.arange(r * max_blk, (r + 1) * max_blk, dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, 40), generator=gen)
    toks[2, :12] = toks[1, :12]
    first = torch.zeros((B, C), dtype=torch.long)
    first[1], first[3] = toks[1, :C], toks[3, :C]
    nval = torch.tensor([0, 16, 0, 11])
    model.prefill_chunk_paged(params, first, torch.zeros(B, dtype=torch.long), nval,
                              pools, table)
    # row 2: row 1's first block read-shared, its second copied on write
    cow = B * max_blk
    for pool in pools:
        for n in ("k", "v"):
            pool[n][cow] = pool[n][int(table[1, 1])]
    table[2, 0], table[2, 1] = table[1, 0], cow
    pos0 = torch.tensor([0, 16, 12, 0])
    n_valid = torch.tensor([9, 16, 13, 0])
    second = torch.zeros((B, C), dtype=torch.long)
    for r in range(3):
        second[r, :int(n_valid[r])] = toks[r, int(pos0[r]):int(pos0[r] + n_valid[r])]
    return model, params, pools, table, second, pos0, n_valid


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_compact_call_equals_the_pool_wide_one(arch):
    model, params, pools, table, toks, pos0, n_valid = _pool_setup(_cfg(arch))
    wide_pools = P.tree_map(torch.clone, pools)
    wide, _ = model.prefill_chunk_paged(params, toks, pos0, n_valid, wide_pools, table)
    rows = torch.tensor([0, 1, 2])
    bs = pools[0]["k"].shape[1]
    n_blk = math.ceil(int((pos0 + n_valid)[rows].max()) / bs)
    assert n_blk < table.shape[1]
    compact, _ = model.prefill_chunk_paged(params, toks[rows], pos0[rows], n_valid[rows],
                                           pools, table[rows, :n_blk])
    torch.testing.assert_close(compact, wide[rows], rtol=0, atol=1e-6)
    for got, want in zip(P.tree_leaves(pools), P.tree_leaves(wide_pools)):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_seeded_sampling_matches_the_pool_wide_call(arch):
    """Temperature 0.8, top-p 0.9: each row's draw comes from the same place
    of the generator's (capacity, vocab) draw as in a pool-wide call."""
    cfg = _cfg(arch)
    params = _f32_params(make_model(cfg, F32))
    engines = [InferenceEngine(cfg, params=params, kv_backend="paged", perf=F32, seed=3,
                               **KW) for _ in range(2)]
    wide = engines[1]
    real_chunks, real_call = wide._run_chunks, wide.model.prefill_chunk_paged
    advancing = []

    def run_chunks(rows_n, now, clock):
        advancing[:] = sorted(rows_n)
        return real_chunks(rows_n, now, clock)

    def pool_wide(params, tokens, pos0, n_valid, pools, table):
        B, rows = wide.capacity, torch.tensor(advancing)
        full = [torch.zeros((B, *a.shape[1:]), dtype=a.dtype).index_copy_(0, rows, a)
                for a in (tokens, pos0, n_valid)]
        logits, pools = real_call(params, *full, pools,
                                  torch.as_tensor(wide.block_tables))
        return logits[rows], pools

    wide._run_chunks, wide.model.prefill_chunk_paged = run_chunks, pool_wide

    def sampling():
        return SamplingParams(max_new_tokens=6, temperature=0.8, top_p=0.9)

    outs = [_serve(eng, sampling) for eng in engines]
    assert len(outs[0]) == 8 and outs[0] == outs[1]
    # the sampler drew: not every row's tokens are its greedy ones
    greedy = _serve(InferenceEngine(cfg, params=params, kv_backend="paged", perf=F32,
                                    seed=3, **KW),
                    lambda: SamplingParams(max_new_tokens=6))
    assert greedy != outs[0]
