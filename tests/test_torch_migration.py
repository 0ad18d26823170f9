"""The port's migration data plane against the JAX engine's, on the CPU.

Both packages get the same f32 weights (the reference's seeded init,
passed through ``from_jax``) and the same requests on a logical clock.
Each scenario runs once per package through the same code; the payload
metadata, byte counts, migration events and greedy tokens must be equal,
and the tokens equal to the same request served unmigrated.  The port's
own checks: an adopted row holds the payload bit for bit, and a payload is
a copy — a request admitted into the freed row or blocks before the
transfer lands does not change what the destination decodes.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.perf import PerfConfig as JPerfConfig
from repro.core.migration import MigrationConfig as JMigrationConfig
from repro.core.migration import MigrationManager as JMigrationManager
from repro.models import params as JP
from repro.models.lm import make_model as jax_make_model
from repro.serving import InferenceEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.core.migration import MigrationConfig, MigrationManager
from repro_torch.models.params import from_jax
from repro_torch.serving import InferenceEngine, Request, SamplingParams

QWEN = "qwen2-0.5b-smoke"
MAMBA = "mamba2-780m-smoke"
KW = {QWEN: dict(capacity=4, max_len=64, buckets=(8, 16), block_size=8, seed=0),
      MAMBA: dict(capacity=3, max_len=64, buckets=(8, 16), seed=0)}
PROMPT = list(range(1, 13))          # bucketed on (8, 16)
LONG = list(range(1, 25))            # chunked: 16 + 8
MAX_NEW = 10


def _weights(arch):
    """The reference's seeded init in f32 and in bf16, for both packages."""
    jcfg = jax_get_config(arch)
    raw = jax.tree.map(np.asarray, jax.jit(lambda k: JP.init(
        k, jax_make_model(jcfg).param_specs()))(jax.random.PRNGKey(0)))
    out = []
    for dtype in (np.float32, jnp.bfloat16):
        cast = jax.tree.map(lambda a: a.astype(dtype), raw)
        out.append((jax.tree.map(jnp.asarray, cast),
                    from_jax(cast, get_config(arch))))
    return out


def _settled(eng):
    """The reference engine, made to wait for its device work at the end of
    every step.  It hands its host block table to an asynchronous JAX call
    and edits the table in place afterwards (a chunk step that samples no
    token never waits), and on the CPU ``jnp.asarray`` may read the numpy
    buffer only when the call runs: under load, a row extracted right after
    such a step can lose that chunk's KV.  Waiting removes the race and
    changes nothing the engine computes."""
    step = eng.step

    def settled_step(now=None):
        st = step(now)
        jax.block_until_ready(eng.caches)
        return st

    eng.step = settled_step
    return eng


@pytest.fixture(scope="module")
def pkgs():
    """One namespace per package, so each scenario runs the same code on
    both: (reference, port)."""
    out = {}
    for arch in (QWEN, MAMBA):
        (jp, tp), (jb, tb) = _weights(arch)
        out[arch] = (
            types.SimpleNamespace(
                Engine=lambda *a, **k: _settled(JEngine(*a, **k)),
                Request=JRequest, SP=JSamplingParams,
                Manager=JMigrationManager, MConfig=JMigrationConfig,
                Perf=JPerfConfig, cfg=jax_get_config(arch), params=jp,
                params_bf16=jb, ekw={}, arch=arch),
            types.SimpleNamespace(
                Engine=InferenceEngine, Request=Request, SP=SamplingParams,
                Manager=MigrationManager, MConfig=MigrationConfig,
                Perf=PerfConfig, cfg=get_config(arch), params=tp,
                params_bf16=tb, ekw={"device": "cpu"}, arch=arch))
    return out


def _engine(ns, backend, **kw):
    kw = {**KW[ns.arch], "params": ns.params, **kw}
    return ns.Engine(ns.cfg, kv_backend=backend, **ns.ekw, **kw)


def _req(ns, rid, prompt, max_new=MAX_NEW):
    return ns.Request(rid=rid, prompt=list(prompt),
                      sampling=ns.SP(max_new_tokens=max_new))


def _finish(eng, t=100.0):
    while eng.pending():
        eng.step(t)
        t += 1.0
    return {r.rid: list(r.output) for r in eng.finished}


def _warm(ns, backend, phase, **kw):
    """Source and destination engines; the source serves one request to
    the phase asked for (decode: 3 tokens out; prefill: one chunk in)."""
    a, b = _engine(ns, backend, **kw), _engine(ns, backend)
    prompt = LONG if phase == "prefill" else PROMPT
    a.submit(_req(ns, 0, prompt), now=0.0)
    for t in range(1 if phase == "prefill" else 3):
        a.step(float(t))
    return a, b, prompt


def _unmigrated(ns, backend, prompt):
    e = _engine(ns, backend)
    e.submit(_req(ns, 0, prompt), now=0.0)
    return _finish(e, 0.0)[0]


def _chunk(ns, b, ticket, payload, i):
    """Transfer chunk ``i`` of an adoption, cut by the package's own
    migration layer."""
    st = b._pending_adopt[ticket]
    tr = types.SimpleNamespace(payload=payload, n_keep=st["n_keep"], dst=b)
    return ns.Manager()._chunk_data(tr, i)


def _meta(payload):
    keys = ("pos", "phase", "kind", "n_blocks", "seq", "last_token")
    return {k: payload[k] for k in keys if k in payload}


def _assert_holds_payload(eng, row, payload):
    """The port's destination row holds the payload bit for bit."""
    if payload["kind"] == "paged":
        got = eng._gather_blocks(eng._row_blocks[row][: payload["n_blocks"]])
        want = payload["blocks"]
    else:
        idx = torch.tensor([row])
        got = [{n: t.index_select(0, idx) for n, t in pool.items()}
               for pool in eng.caches]
        want = payload["caches"]
    for g, w in zip(got, want):
        for n in w:
            assert torch.equal(g[n], w[n].to(g[n].dtype)), n


# ------------------------------------------------------------ sync handoff
def _handoff(ns, backend, phase):
    a, b, prompt = _warm(ns, backend, phase)
    nbytes = [a.kv_bytes(0), a.kv_per_block_bytes() if a.paged else None]
    req, payload = a.extract_row(0, now=5.0)
    meta = _meta(payload)
    assert b.adopt(req, payload, now=5.0)
    if ns.Engine is InferenceEngine:
        _assert_holds_payload(b, req.row, payload)
    assert a.pending() == 0 and req.migrations == 1
    return meta, nbytes, _finish(b), prompt


@pytest.mark.parametrize("arch,backend,phase", [
    (QWEN, "dense", "decode"), (QWEN, "dense", "prefill"),
    (QWEN, "paged", "decode"), (QWEN, "paged", "prefill"),
    (MAMBA, "dense", "decode"), (MAMBA, "dense", "prefill")])
def test_extract_adopt_matches_reference(pkgs, arch, backend, phase):
    jns, tns = pkgs[arch]
    ref = _handoff(jns, backend, phase)
    got = _handoff(tns, backend, phase)
    assert got[0] == ref[0], "payload metadata differs"
    assert got[0]["phase"] == phase
    if arch == QWEN:        # mamba: see _bytes
        assert got[1] == ref[1], "kv_bytes / kv_per_block_bytes differ"
    assert got[2] == ref[2], "greedy tokens after migration differ"
    assert got[2][0] == _unmigrated(tns, backend, got[3]), \
        "migration changed the tokens"


# ----------------------------------------------------- block-granular path
def _out_of_order(ns, backend):
    """begin_adopt, then every chunk in reverse order and a second time,
    then commit; a second adoption is aborted after its first chunk and
    must leave no trace."""
    a, b, prompt = _warm(ns, backend, "decode")
    a.submit(_req(ns, 1, LONG), now=3.0)
    a.step(3.0)
    req, payload = a.extract_row(0, now=5.0)
    ticket = b.begin_adopt(req, payload, now=5.0)
    n = b._pending_adopt[ticket]["expected"]
    for i in list(reversed(range(n))) + list(range(n)):
        b.feed_adopt(ticket, i, _chunk(ns, b, ticket, payload, i))
    b.commit_adopt(ticket, now=5.0)

    def state():
        return (b.pool.used, b.prefix.free_blocks if b.paged else None,
                b.prefix.used_blocks if b.paged else None)

    before = state()
    req1, payload1 = a.extract_row(1, now=5.0)
    t1 = b.begin_adopt(req1, payload1, now=5.0)
    b.feed_adopt(t1, 0, _chunk(ns, b, t1, payload1, 0))
    b.abort_adopt(t1)
    assert state() == before and list(b._pending_adopt) == []
    if b.paged:
        b.prefix.check_invariants()
    return n, _finish(b), prompt


@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_feed_out_of_order_commit_and_abort_match_reference(pkgs, backend):
    jns, tns = pkgs[QWEN]
    ref = _out_of_order(jns, backend)
    got = _out_of_order(tns, backend)
    assert got[:2] == ref[:2]
    assert got[0] > (1 if backend == "paged" else 0), "one chunk per block"
    assert got[1][0] == _unmigrated(tns, backend, got[2])


# ------------------------------------------------ cross-backend conversion
def _convert(ns, src, dst):
    a, b = _engine(ns, src), _engine(ns, dst)
    a.submit(_req(ns, 0, PROMPT), now=0.0)
    for t in range(3):
        a.step(float(t))
    mgr = ns.Manager(ns.MConfig())
    ev = mgr.migrate(a, b, 0, 5.0)
    assert ev is not None, mgr.failures
    out = _finish(b)
    if b.paged:
        b.prefix.check_invariants()
    return dataclasses.asdict(ev), out


@pytest.mark.parametrize("src,dst", [("dense", "paged"), ("paged", "dense")])
def test_convert_payload_matches_reference(pkgs, src, dst):
    jns, tns = pkgs[QWEN]
    ref = _convert(jns, src, dst)
    got = _convert(tns, src, dst)
    assert got == ref
    assert got[1][0] == _unmigrated(tns, src, PROMPT)


def test_convert_payload_round_trip_is_exact(pkgs):
    """dense -> paged -> dense gives the row back bit for bit over the
    payload's whole blocks, and zeros past them."""
    _, tns = pkgs[QWEN]
    a, b, _ = _warm(tns, "dense", "decode")
    c = _engine(tns, "paged")
    req, payload = a.extract_row(0, now=5.0)
    paged = c.convert_payload(req, payload)
    assert paged["n_blocks"] == -(-payload["pos"] // c.block_size)
    back = b.convert_payload(req, paged)
    span = paged["n_blocks"] * c.block_size
    for got, want in zip(back["caches"], payload["caches"]):
        for n in want:
            assert torch.equal(got[n][:, :span], want[n][:, :span])
            assert not got[n][:, span:].any()
    assert c.convert_payload(req, paged) is paged


# -------------------------------------------------------------- byte counts
def _bytes(ns, backend, kv_dtype):
    # bf16 weights: with f32 ones the dense pool's SSM conv tails widen to
    # f32 at the first decode step (in both packages), so the counts would
    # depend on when a row was measured
    e = _engine(ns, backend, perf=ns.Perf(kv_dtype=kv_dtype),
                params=ns.params_bf16)
    e.submit(_req(ns, 0, PROMPT), now=0.0)
    e.submit(_req(ns, 1, LONG + LONG), now=0.0)
    out = []
    for t in range(2):
        e.step(float(t))
        out.append([e.kv_bytes(r.rid) for r in e.migratable_requests()])
    if e.paged:
        out.append(e.kv_per_block_bytes())
    return out


@pytest.mark.parametrize("arch,backend,kv_dtype", [
    (QWEN, "paged", "float32"), (MAMBA, "dense", "bfloat16")])
def test_kv_bytes_match_reference(pkgs, arch, backend, kv_dtype):
    """Byte counts of a decoding row and a chunked row mid-prefill (the
    handoff test holds the bf16 paged and dense counts of qwen2)."""
    jns, tns = pkgs[arch]
    got = _bytes(tns, backend, kv_dtype)
    assert got == _bytes(jns, backend, kv_dtype)
    assert all(got[:2]), "both requests should be migratable"


# ------------------------------------------------------- payload is a copy
@pytest.mark.parametrize("backend", ["dense", "paged"])
def test_payload_is_a_copy(pkgs, backend):
    """Extract, reserve the destination, then admit a new request into the
    source's freed row (dense) or its evicted blocks (paged) and prefill
    it; only then land the chunks and commit.  A payload that aliased the
    source's pool would carry the new request's KV."""
    jns, tns = pkgs[QWEN]
    kw = {"num_blocks": 8} if backend == "paged" else {}
    a, b, prompt = _warm(tns, backend, "decode", **kw)
    row0 = a._find_row(0)[0]
    blocks0 = set(a._row_blocks[row0]) if a.paged else set()
    req, payload = a.extract_row(0, now=5.0)
    ticket = b.begin_adopt(req, payload, now=5.0)

    # 52 + 8 tokens fill all 8 blocks: the 2 donated ones are evicted
    other = [int(x) for x in np.random.default_rng(1).integers(0, 500, 52)]
    a.submit(_req(tns, 1, other, max_new=8), now=5.0)
    for t in range(5):
        a.step(6.0 + t)
    row1 = a._find_row(1)[0]
    if a.paged:
        assert blocks0 & set(a._row_blocks[row1]), "blocks were not reused"
    else:
        assert row1 == row0, "the row was not reused"

    for i in range(b._pending_adopt[ticket]["expected"]):
        b.feed_adopt(ticket, i, _chunk(tns, b, ticket, payload, i))
    b.commit_adopt(ticket, now=10.0)
    assert _finish(b)[0] == _unmigrated(jns, backend, prompt)
