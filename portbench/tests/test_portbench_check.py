"""The check fails a run whose timed path is broken underneath, once for
each fault a serving cell can have, and the precision control fails it
too.  (A cell runs on one card: there is no exchange between cards to
leave out.)"""
import pytest

from smoke import CHAT, MOE, run


def state_unchanged(engine):
    """Decode steps leave the KV pools as they found them."""
    model, step = engine.model, engine.model.decode_step_paged

    def call(params, tokens, pos, pools, block_table, live=None, **kw):
        saved = [{k: v.clone() for k, v in p.items()} for p in pools]
        out = step(params, tokens, pos, pools, block_table, live, **kw)
        for p, s in zip(pools, saved):
            for k in p:
                p[k].copy_(s[k])
        return out
    model.decode_step_paged = call


def half_batch(engine):
    """Decode steps compute only half of the rows (the even ones)."""
    model, step = engine.model, engine.model.decode_step_paged

    def call(*args, **kw):
        logits, pools = step(*args, **kw)
        logits = logits.clone()
        logits[1::2] = 0.0
        return logits, pools
    model.decode_step_paged = call


def token_altered(engine):
    """The sampler's tokens come out one higher."""
    sample, vocab = engine._sample, engine.cfg.vocab_size
    engine._sample = lambda *a: (sample(*a) + 1) % vocab


@pytest.mark.parametrize("fault", [state_unchanged, half_batch, token_altered])
@pytest.mark.parametrize("cell", [CHAT, MOE])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    res, _ = run(cell, sabotage=fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [CHAT, MOE])
def test_the_precision_control_fails_the_limit(cell):
    """The reference in float8, put in the program's place, is judged not
    correct by the cell's own limits, where the program is."""
    res, _ = run(cell, control=True)
    c = res["checks"]
    assert res["correct"] is False, c
    assert res["program_correct"] is True, c
    assert c["logit_gap_max"]["value"] > c["logit_gap_max"]["limit"] \
        >= c["program_logit_gap_max"]["value"]
