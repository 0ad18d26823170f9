"""Decoder-only LM of the port: dense global-attention decoders (qwen2,
gemma-2b), MoE decoders with q/k RMSNorm (qwen3-moe), windowed decoders
(gemma3's local and global layers, mixtral's uniform sliding window),
attention-free SSM decoders (mamba2), hybrid stacks of SSM, attention and
MoE layers (jamba) and a vision-language decoder whose prompt opens with
precomputed patch embeddings under a prefix-LM mask (paligemma).
``make_model`` returns the encoder-decoder (``models/whisper.py``) for
whisper.

The reference runs a ``lax.scan`` over stacked layer groups; here the trunk
is a plain loop over ``params["layers"]``, one dict per layer.  Caches are
lists with one dict per layer, updated in place: ``{"k", "v"}`` on
global attention layers (slot = absolute position), ``{"k", "v", "pos"}``
ring caches of ``min(window, max_len)`` slots on windowed layers (slot =
position mod length, ``pos`` the position a slot holds, -1 when empty),
``{"h", "conv_x", "conv_B", "conv_C"}`` on SSM layers.

Modes:
  train         full sequence, no cache, layer groups under remat (``loss``)
  prefill       full sequence; emits fresh per-layer caches
  chunk         a chunk of a long prompt appended into the row caches
  decode        one token per row at per-row positions
  paged_decode  decode against paged KV pools through a block table
  paged_chunk   chunked prefill appending into paged pools

``shd`` is the reference's sharding hook (``layers.noop_shd`` on one card).
A sharded step (``distributed.spmd.Spmd``) runs modes ``prefill`` and
``decode`` on each device's shards; the engine's chunk and paged modes
run on one card.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.kernels.flash_attention.ops import attention as flash_attention
from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import params as P


def block_specs(cfg: ModelConfig, kind: str, is_moe: bool) -> dict:
    mixer = M.ssd_specs(cfg) if kind == "ssm" else L.attention_specs(cfg)
    return {"ln1": L.rmsnorm_specs(cfg.d_model), "mixer": mixer,
            "ln2": L.rmsnorm_specs(cfg.d_model),
            "mlp": L.moe_specs(cfg) if is_moe else L.mlp_specs(cfg)}


def torch_dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


_NO_RANGE = contextlib.nullcontext()


class LM:
    #: ``torch.profiler.record_function`` ranges around the embedding
    #: (``lm.embed``), the write-slot plan (``lm.slots``), each layer's mixer
    #: (``lm.attention`` / ``lm.ssm``) and MLP (``lm.mlp`` / ``lm.moe``) and
    #: the logits (``lm.logits``); the engine turns them on for the steps its
    #: tracer records while a profiler runs
    ranges = False

    def __init__(self, cfg: ModelConfig, perf: PerfConfig = BASELINE):
        self.cfg = cfg
        self.perf = perf
        self.kinds = [cfg.layer_kind(i) for i in range(cfg.num_layers)]
        self.moes = [cfg.layer_is_moe(i) for i in range(cfg.num_layers)]

    # ------------------------------------------------------------- specs
    def param_specs(self) -> dict:
        cfg = self.cfg
        return {"embed": L.embed_specs(cfg),
                "final_norm": L.rmsnorm_specs(cfg.d_model),
                "layers": [block_specs(cfg, k, m) for k, m in zip(self.kinds, self.moes)]}

    def _cache_len(self, kind: str, max_len: int) -> int:
        """KV slots of a layer kind: a ring of the window on windowed
        layers (``window_for(kind) > 0``), ``max_len`` on global ones."""
        w = self.cfg.window_for(kind)
        return min(w, max_len) if w else max_len

    def cache_specs(self, batch: int, max_len: int) -> list:
        """Per-layer caches; every entry has its batch axis first."""
        cfg = self.cfg
        return [M.ssm_cache_specs(cfg, batch) if k == "ssm"
                else L.kv_cache_specs(cfg, batch, self._cache_len(k, max_len),
                                      ring=cfg.window_for(k) > 0)
                for k in self.kinds]

    def supports_paged(self) -> bool:
        """Paged KV serving covers text decoders whose every layer is global
        attention.  SSM state is per row (nothing to page), ring layers
        keep their own slot positions and a vision prefix pins the
        sequence's layout: the engine keeps the dense backend for those."""
        return (not self.cfg.num_vision_tokens and set(self.kinds) == {"attn"}
                and self.cfg.window_for("attn") == 0)

    def paged_cache_specs(self, num_blocks: int, block_size: int) -> list:
        """Per-layer paged pools, indexed through one shared block table."""
        if not self.supports_paged():
            raise ValueError(f"{self.cfg.name}: not paged-servable")
        cfg = self.cfg
        shape = (num_blocks, block_size, cfg.num_kv_heads, cfg.head_dim)
        axes = ("kv_blocks", "kv_slot", "kv_heads", "qkv")
        dt = torch_dtype(self.perf.kv_dtype)
        return [{"k": P.ParamSpec(shape, axes, dtype=dt, init="zeros"),
                 "v": P.ParamSpec(shape, axes, dtype=dt, init="zeros")}
                for _ in range(cfg.num_layers)]

    # ------------------------------------------------------------- blocks
    def _range(self, name: str):
        return torch.profiler.record_function(name) if self.ranges else _NO_RANGE

    def _embed(self, params, tokens, shd):
        with self._range("lm.embed"):
            return L.embed_apply(params["embed"], tokens, self.cfg, shd)

    def _theta(self, kind: str) -> float:
        cfg = self.cfg
        return cfg.rope_theta_local if kind == "attn_local" else cfg.rope_theta

    def _prefill_cache(self, kind, k, v, max_len, true_len):
        """A fresh cache of ``max_len`` (a ring's length) holding a full
        prefill's k/v, in ``perf.kv_dtype``, with k's KV heads."""
        ring = self.cfg.window_for(kind) > 0
        specs = L.kv_cache_specs(self.cfg, k.shape[0], self._cache_len(kind, max_len),
                                 ring=ring, heads=k.shape[2])
        dt = torch_dtype(self.perf.kv_dtype)
        empty = {name: t.to(dt) if t.is_floating_point() else t
                 for name, t in P.init(None, specs, k.device).items()}
        return L.cache_write_prefill(empty, k, v, ring=ring, true_len=true_len)

    def _attend(self, p, h, kind, *, mode, positions, cache, pos, max_len,
                true_len, block_table, live, slots, angles, prefix_len,
                shd=L.noop_shd):
        # imported here: repro_torch.serving imports the engine, which
        # imports this module
        from repro_torch.serving.kv_cache import (paged_gather, paged_write,
                                                  paged_write_chunk)
        cfg, perf = self.cfg, self.perf
        window = cfg.window_for(kind)
        ring = window > 0
        q, k, v = L._project_qkv(p, h, cfg, positions, self._theta(kind),
                                 angles=angles)
        q = shd(q, ("batch", "act_seq", "heads", "qkv"))
        # a sharded step: this device's query and KV heads, as the
        # projections left them; the caches in the rules' layout
        sp = L.mesh_of(shd)
        if sp is not None and mode not in ("prefill", "decode"):
            raise NotImplementedError(f"mode {mode!r} on a mesh")
        h_axes, k_axes = L.head_axes(sp, cfg)
        new_cache = None
        if mode == "decode":
            ctx = L.attend_decode(sp, cfg, q, k, v, cache, pos,
                                  length=self._cache_len(kind, sp.kv_len) if sp else 0,
                                  h_axes=h_axes, k_axes=k_axes, ring=ring,
                                  window=window, live=live)
            new_cache = cache
        elif mode == "paged_decode":
            paged_write(cache["k"], cache["v"], block_table, pos, k[:, 0], v[:, 0],
                        live=live, slots=slots)
            if perf.use_kernels:
                ctx_len = pos + 1
                if live is not None:
                    ctx_len = torch.where(live, ctx_len, torch.zeros_like(ctx_len))
                ctx = paged_decode_attention(
                    q[:, 0], cache["k"], cache["v"], block_table,
                    ctx_len.to(torch.int32))[:, None]
            else:
                S_ctx = block_table.shape[1] * cache["k"].shape[1]
                gk = paged_gather(cache["k"], block_table, S_ctx)
                gv = paged_gather(cache["v"], block_table, S_ctx)
                mask = (torch.arange(S_ctx, device=pos.device)[None, :]
                        <= pos.long()[:, None])
                if live is not None:
                    mask = mask & live[:, None]
                ctx = L.attention_decode(q, gk.to(q.dtype), gv.to(q.dtype), mask)
            new_cache = cache
        elif mode == "paged_chunk":
            # attend previously written blocks (positions < pos0) through a
            # gathered contiguous view, then append this chunk's k/v
            S_ctx = block_table.shape[1] * cache["k"].shape[1]
            gk = paged_gather(cache["k"], block_table, S_ctx).to(q.dtype)
            gv = paged_gather(cache["v"], block_table, S_ctx).to(q.dtype)
            ctx = L.attention_chunk(q, k, v, {"k": gk, "v": gv}, pos,
                                    q_chunk=perf.q_chunk)
            paged_write_chunk(cache["k"], cache["v"], block_table, pos,
                              true_len, k, v, slots=slots)
            new_cache = cache
        elif mode == "chunk":
            # attend the pre-write cache + this chunk's own k/v, then append
            ctx = L.attention_chunk(q, k, v, cache, pos, window=window,
                                    ring=ring, q_chunk=perf.q_chunk)
            new_cache = L.cache_write_chunk(cache, k, v, pos, true_len,
                                            ring=ring, slots=slots)
        elif mode == "train":
            # the kernels have no backward: the plain attention, no cache
            ctx = L.attention_full(q, k, v, causal=True, window=window,
                                   prefix_len=prefix_len, q_chunk=perf.q_chunk)
        else:  # prefill
            # flash has no prefix-LM mask: a vision prefix takes the plain
            # path, as in the reference
            kq, vq = L.kv_for_queries(sp, cfg, k, v, h_axes, k_axes)
            if perf.use_kernels and prefix_len == 0:
                ctx = flash_attention(q, kq, vq, causal=True, window=window)
            else:
                ctx = L.attention_full(q, kq, vq, causal=True, window=window,
                                       prefix_len=prefix_len,
                                       q_chunk=perf.q_chunk)
            new_cache = L.cache_to_mesh(sp, cfg,
                                        self._prefill_cache(kind, k, v, max_len, true_len),
                                        self._cache_len(kind, max_len), k_axes)
        return L.reduce(sp, L.attn_out(p, ctx), h_axes), new_cache

    def _ssm(self, p, h, *, mode, cache, true_len, live, shd=L.noop_shd):
        cfg = self.cfg
        if L.mesh_of(shd) is not None and mode not in ("prefill", "decode"):
            raise NotImplementedError(f"mode {mode!r} on a mesh")
        if mode == "decode":
            return M.ssd_apply_decode(p, h, cache, cfg, shd, live=live), cache
        if mode == "chunk":
            return M.ssd_apply_chunk(p, h, cache, cfg, shd, true_len=true_len), cache
        if mode == "train":
            return M.ssd_apply_full(p, h, cfg, shd, want_state=False, use_kernels=False)
        if mode != "prefill":
            raise ValueError(f"{cfg.name}: SSM layers have no {mode} mode")
        return M.ssd_apply_full(p, h, cfg, shd, want_state=True, true_len=true_len,
                                use_kernels=self.perf.use_kernels)

    def _write_slots(self, mode, C, kinds, caches, pos, true_len, block_table, live):
        """Where this pass's cache writes land, per layer of ``kinds``: the
        same in every layer with a cache of one kind and length, so computed
        (with its one device sync on global caches) once for each."""
        from repro_torch.serving.kv_cache import (paged_write_chunk_slots,
                                                  paged_write_slots)
        n = len(kinds)
        if mode == "paged_decode":
            return [paged_write_slots(block_table, pos, caches[0]["k"].shape[1],
                                      live)] * n
        if mode == "paged_chunk":
            return [paged_write_chunk_slots(block_table, pos, true_len, C,
                                            caches[0]["k"].shape[1])] * n
        if mode != "chunk":
            return [None] * n
        by_len: dict = {}
        out = []
        for cache, kind in zip(caches, kinds):
            if kind == "ssm":
                out.append(None)
                continue
            # ring slots depend on the ring's length; global slots on none
            key = cache["k"].shape[1] if self.cfg.window_for(kind) else None
            if key not in by_len:
                by_len[key] = (L.chunk_write_slots(pos, true_len, C) if key is None
                               else L.ring_write_slots(pos, true_len, C, key))
            out.append(by_len[key])
        return out

    def _layer(self, i, p, x, *, mode, cache, slots, angles, shd=L.noop_shd, **kw):
        """Layer ``i``: mixer and MLP, each behind its norm and residual.
        Returns (x, the layer's new cache, its MoE aux loss or None).  In a
        sharded step the layer's weights split over a batch axis are
        gathered first (``zero3``)."""
        cfg, kind = self.cfg, self.kinds[i]
        sp = L.mesh_of(shd)
        if sp is not None:
            p = sp.weights(p, block_specs(cfg, kind, self.moes[i]))
        with self._range("lm.ssm" if kind == "ssm" else "lm.attention"):
            h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
            if kind == "ssm":
                mix, nc = self._ssm(p["mixer"], h, mode=mode, cache=cache, shd=shd,
                                    true_len=kw["true_len"], live=kw["live"])
            else:
                mix, nc = self._attend(p["mixer"], h, kind, mode=mode, cache=cache,
                                       slots=slots, angles=angles[self._theta(kind)],
                                       shd=shd, **kw)
            x = x + mix
        aux = None
        if self.moes[i]:
            with self._range("lm.moe"):
                y, aux = L.moe_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                                     cfg, shd)
                x = x + y
        elif cfg.d_ff:    # at d_ff = 0 the reference's MLP adds exactly 0
            with self._range("lm.mlp"):
                x = x + L.mlp_apply(p["mlp"], L.rmsnorm(p["ln2"], x, cfg.norm_eps),
                                    cfg, shd)
        return x, nc, aux

    def _trunk(self, params, x, *, mode, positions, caches=None, pos=None,
               max_len=0, true_len=None, block_table=None, live=None,
               prefix_len=0, lo=0, shd=L.noop_shd):
        """Run the layers of ``params["layers"]`` (and of ``caches``), which
        are the model's layers ``lo, lo + 1, ...``: every layer by default,
        a stage's range in ``core.microservice``.  Returns (x, new caches,
        the MoE layers' summed aux loss), as the reference's trunk does.
        Serving ignores aux.  Mode ``train`` writes no cache and runs each
        group of the reference's scan unit (``params.group_period`` layers)
        under ``perf.remat``."""
        cfg = self.cfg
        layers = params["layers"]
        kinds = self.kinds[lo:lo + len(layers)]
        slots = angles = None
        if any(k != "ssm" for k in kinds):
            with self._range("lm.slots"):
                slots = self._write_slots(mode, x.shape[1], kinds, caches, pos,
                                          true_len, block_table, live)
            # one rope table for each theta (gemma3: local and global), none
            # without rope (jamba)
            angles = {th: L.rope_angles(positions, cfg.head_dim, th) if cfg.use_rope
                      else None
                      for th in {self._theta(k) for k in kinds if k != "ssm"}}
        kw = dict(positions=positions, pos=pos, max_len=max_len, true_len=true_len,
                  block_table=block_table, live=live, prefix_len=prefix_len)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if mode == "train":
            def group(x, lo, hi):
                a = torch.zeros((), dtype=torch.float32, device=x.device)
                for i in range(lo, hi):
                    x, _, ai = self._layer(i, layers[i], x, mode=mode, cache=None,
                                           slots=None, angles=angles, shd=shd, **kw)
                    if ai is not None:
                        a = a + ai
                return x, a

            period, n = P.group_period(cfg), len(layers)
            for g0 in range(0, n, period):
                x, a = L.remat(self.perf.remat, group, x, g0, min(g0 + period, n))
                aux = aux + a
            return x, None, aux
        new_caches = []
        for j, p in enumerate(layers):
            x, nc, a = self._layer(lo + j, p, x, mode=mode,
                                   cache=None if caches is None else caches[j],
                                   slots=slots[j] if slots else None, angles=angles,
                                   shd=shd, **kw)
            new_caches.append(nc)
            if a is not None:
                aux = aux + a
        return x, new_caches, aux

    def _last_logits(self, params, x, idx, shd=L.noop_shd):
        """Final norm + f32 logits at per-row sequence index ``idx`` (B,)."""
        with self._range("lm.logits"):
            x = L.rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
            rows = torch.arange(x.shape[0], device=x.device)
            x_last = x[rows, idx.long()][:, None]
            return L.unembed_logits(params["embed"], x_last, self.cfg, shd=shd)[:, 0]

    def _embed_inputs(self, params, batch, shd=L.noop_shd):
        """tokens, and a vlm's patches (B, num_vision_tokens, d_model) put
        before them -> (x, positions, prefix_len).  The patches are cast to
        the activations' dtype and, like the token embeddings, scaled by
        sqrt(d_model) under ``scale_embed``."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"], shd)
        prefix = 0
        if cfg.num_vision_tokens:
            patches = batch["patches"].to(x.dtype)
            if cfg.scale_embed:
                patches = patches * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype)
            x = torch.cat([patches, x], dim=1)
            prefix = cfg.num_vision_tokens
        x = shd(x, L.RESIDUAL)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        return x, positions, prefix

    # ------------------------------------------------------------- public
    def loss(self, params, batch, shd=L.noop_shd):
        """batch: tokens (B,S), labels (B,S) (-1 = ignored), a vlm's patches.
        Returns (mean nll over the valid next-token labels, plus a MoE
        model's aux loss weighted by ``aux_loss_weight`` and averaged over
        the layers; metrics {"nll": summed nll, "tokens": valid labels,
        "aux": summed aux loss}).  A vision prefix's last position predicts
        the first text token."""
        cfg = self.cfg
        x, positions, prefix = self._embed_inputs(params, batch, shd)
        x, _, aux = self._trunk(params, x, mode="train", positions=positions,
                                prefix_len=prefix, shd=shd)
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if prefix:
            x = x[:, prefix - 1:-1]   # hidden states predicting each text token
            labels = batch["labels"]
        else:
            x = x[:, :-1]
            labels = batch["labels"][:, 1:]
        nll, cnt = L.chunked_xent(params["embed"], x, labels, cfg, shd,
                                  chunk=self.perf.xent_chunk)
        loss = nll / cnt.clamp(min=1).to(nll.dtype)
        if cfg.num_experts:
            loss = loss + cfg.aux_loss_weight * aux / max(cfg.num_layers, 1)
        return loss, {"nll": nll, "tokens": cnt, "aux": aux}

    def prefill(self, params, batch, max_len: int, true_len=None, shd=L.noop_shd):
        """Full-sequence prefill.  Returns (last-token logits (B,V) f32, fresh
        per-layer caches: KV of length ``max_len``, SSM state).  ``true_len``
        (B,) counts the valid text tokens of right-padded rows; logits come
        from the last one, and SSM state stops there.  Positions, and the
        caches, count a vision prefix first."""
        B = batch["tokens"].shape[0]
        x, positions, prefix = self._embed_inputs(params, batch, shd)
        abs_len = None if true_len is None else true_len + prefix
        x, caches, _ = self._trunk(params, x, mode="prefill", positions=positions,
                                   max_len=max_len, true_len=abs_len,
                                   prefix_len=prefix, shd=shd)
        if abs_len is None:
            idx = torch.full((B,), x.shape[1] - 1, device=x.device)
        else:
            idx = (abs_len.long() - 1).clamp(min=0)
        return self._last_logits(params, x, idx, shd), caches

    def _chunk_positions(self, tokens, pos0):
        C = tokens.shape[1]
        return pos0.long()[:, None] + torch.arange(C, device=tokens.device)[None, :]

    def prefill_chunk(self, params, tokens, pos0, n_valid, caches, shd=L.noop_shd):
        """One chunk of a long prompt, batched over cache rows (in place).

        tokens (B,C) right-padded; pos0 (B,) absolute start positions;
        n_valid (B,) valid tokens per row — 0 marks an idle row, whose cache
        is left untouched.  Returns (logits (B,V) f32 at each row's last
        valid chunk position, caches).  Text positions only: a vision
        prefix is never chunked (the engine keeps vlm prompts bucketed)."""
        x = shd(self._embed(params, tokens, shd), L.RESIDUAL)
        x, caches, _ = self._trunk(params, x, mode="chunk",
                                   positions=self._chunk_positions(tokens, pos0),
                                   caches=caches, pos=pos0, true_len=n_valid, shd=shd)
        return self._last_logits(params, x, (n_valid.long() - 1).clamp(min=0)), caches

    def decode_step(self, params, tokens, pos, caches, live=None, shd=L.noop_shd):
        """tokens (B,1), pos (B,) absolute positions.  ``live`` (B,) bool:
        False rows take no cache write (rows mid chunked prefill).  Returns
        (logits (B,V) f32, caches)."""
        x = self._embed(params, tokens, shd)
        x, caches, _ = self._trunk(params, x, mode="decode", positions=pos[:, None],
                                   caches=caches, pos=pos, live=live, shd=shd)
        return self._last_logits(params, x, torch.zeros_like(pos), shd), caches

    def decode_step_paged(self, params, tokens, pos, pools, block_table, live=None,
                          shd=L.noop_shd):
        """Decode step against paged KV pools.  block_table (B, max_blk)
        int32, -1 = unmapped; live (B,) bool — False rows (empty or mid
        prefill) neither write their token nor count context."""
        x = self._embed(params, tokens, shd)
        x, pools, _ = self._trunk(params, x, mode="paged_decode",
                                  positions=pos[:, None], caches=pools, pos=pos,
                                  block_table=block_table, live=live, shd=shd)
        return self._last_logits(params, x, torch.zeros_like(pos)), pools

    def prefill_chunk_paged(self, params, tokens, pos0, n_valid, pools, block_table,
                            shd=L.noop_shd):
        """Chunked prefill appending into paged pools.  A prefix-cache hit
        starts the first chunk at pos0 = n_cached.  Rows with n_valid == 0
        are left untouched.  block_table (B, n_blk) need only cover the
        blocks up to the furthest position written: the keys it leaves out
        are masked ones."""
        x = shd(self._embed(params, tokens, shd), L.RESIDUAL)
        x, pools, _ = self._trunk(params, x, mode="paged_chunk",
                                  positions=self._chunk_positions(tokens, pos0),
                                  caches=pools, pos=pos0, true_len=n_valid,
                                  block_table=block_table, shd=shd)
        return self._last_logits(params, x, (n_valid.long() - 1).clamp(min=0)), pools


def make_model(cfg: ModelConfig, perf: PerfConfig = BASELINE):
    if cfg.is_encoder_decoder:
        from repro_torch.models.whisper import EncDec
        return EncDec(cfg, perf)
    return LM(cfg, perf)
