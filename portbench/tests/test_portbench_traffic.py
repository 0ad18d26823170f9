"""The generator's draws repeat exactly by seed, and every seed offers the
same multiset of sizes and gaps."""
import json

from portbench.traffic import generator
from smoke import ROOT


def mix(name, **load):
    with open(ROOT / "portbench" / "traffic" / f"{name}.json") as f:
        return {**json.load(f), **load}


def test_open_loop_repeats_by_seed_and_keeps_its_multiset():
    m = mix("chat-prefix", rate=2.0)
    a = generator.build(m, 2 ** 31 + 5, 30.0, 151936)
    b = generator.build(m, 2 ** 31 + 5, 30.0, 151936)
    c = generator.build(m, 9, 30.0, 151936)
    assert [(i.prompt, i.max_new, i.due) for i in a.items] == \
        [(i.prompt, i.max_new, i.due) for i in b.items]
    assert [i.prompt for i in a.items] != [i.prompt for i in c.items]
    assert len(a.items) == len(c.items)
    assert sorted(len(i.prompt) for i in a.items) == sorted(len(i.prompt) for i in c.items)
    assert sorted(i.max_new for i in a.items) == sorted(i.max_new for i in c.items)
    assert [i.due for i in a.items] == [i.due for i in c.items]
    assert all(0 < i.due < 30.0 for i in a.items)
    for it in a.items:
        head = a.prefixes[it.prefix]
        assert it.prompt[:1024] == head and 32 <= len(it.prompt) - 1024 <= 512
        assert 16 <= it.max_new <= 384


def test_closed_loop_sends_the_same_sizes_for_every_seed():
    m = mix("decode-heavy")
    a = generator.build(m, 123, 30.0, 1000)
    b = generator.build(m, 123, 30.0, 1000)
    c = generator.build(m, 456, 30.0, 1000)
    assert len(a.initial) == 32
    assert [(i.prompt, i.max_new) for i in a.initial] == [(i.prompt, i.max_new) for i in b.initial]
    assert sorted(i.max_new for i in a.initial) == sorted(i.max_new for i in c.initial)
    assert sorted(len(i.prompt) for i in a.initial) == sorted(len(i.prompt) for i in c.initial)
    assert all(1 <= i.max_new <= 512 and 64 <= len(i.prompt) <= 512 for i in a.initial)
    sa = [a.next_item() for _ in range(50)]
    sb = [b.next_item() for _ in range(50)]
    sc = [c.next_item() for _ in range(50)]
    assert [(i.prompt, i.max_new) for i in sa] == [(i.prompt, i.max_new) for i in sb]
    assert [(len(i.prompt), i.max_new) for i in sa] == [(len(i.prompt), i.max_new) for i in sc]
    assert [i.prompt for i in sa] != [i.prompt for i in sc]
    assert all(128 <= i.max_new <= 512 for i in sa)


def test_uniform_lengths_cover_both_ends():
    import numpy as np
    x = generator.lengths(np.random.default_rng(0), {"dist": "uniform", "min": 3, "max": 5}, 500)
    assert set(x.tolist()) == {3, 4, 5}
