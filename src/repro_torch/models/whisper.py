"""Whisper-style encoder-decoder of the port, the counterpart of the
reference's ``models/whisper.py``.  The conv frontend is a stub: a request
brings precomputed frame embeddings (B, encoder_seq, d_model).

Encoder: bidirectional attention, learned positions.  Decoder: causal
self-attention, then cross-attention to the encoder's output, learned
positions.  Every norm is a LayerNorm and every MLP the biased GELU one
(``gelu_plain``).  The reference scans stacked layers; here the encoder and
the decoder are lists with one dict per layer.

Caches are a list with one dict per decoder layer, every leaf with its
batch axis first: ``{"self": {"k", "v"}, "cross": {"k", "v"}}``.  The
self-KV has ``max_len`` slots (slot = position), written by prefill and
then one token a decode step, in place.  The cross-KV has ``encoder_seq``
slots, projected from the encoder's output once at prefill; decode reads it
unchanged.

No kernel runs here: the reference takes the plain attention for the
encoder, the decoder's prefill and decode and the cross-attention alike,
and the port does the same.  ``loss`` trains through the same plain
attention, the decoder's layers under ``perf.remat``.

``shd`` is the reference's sharding hook; a sharded step
(``distributed.spmd.Spmd``) runs ``prefill`` and ``decode_step`` on each
device's shards: heads and the MLP's hidden width tensor-parallel, the
caches in the rules' layout (``layers.attend_decode``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.models import layers as L
from repro_torch.models import params as P


def _enc_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": L.layernorm_specs(cfg.d_model), "mixer": L.attention_specs(cfg),
            "ln2": L.layernorm_specs(cfg.d_model), "mlp": L.mlp_specs(cfg)}


def _dec_block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": L.layernorm_specs(cfg.d_model), "self": L.attention_specs(cfg),
            "ln_x": L.layernorm_specs(cfg.d_model),
            "cross": L.attention_specs(cfg, cross=True),
            "ln2": L.layernorm_specs(cfg.d_model), "mlp": L.mlp_specs(cfg)}


def _qkv(p, h):
    """Projections without rope.  ``h`` is cast to the weights' dtype: the
    encoder's first layer normalises bf16 frames, and the reference's
    einsum promotes them to f32 weights exactly so."""
    h = h.to(p["wq"].dtype)
    return L._proj(h, p["wq"]), L._proj(h, p["wk"]), L._proj(h, p["wv"])


class EncDec:
    def __init__(self, cfg: ModelConfig, perf: PerfConfig = BASELINE):
        self.cfg = cfg
        self.perf = perf

    # ------------------------------------------------------------- specs
    def param_specs(self) -> dict:
        cfg = self.cfg
        D = cfg.d_model
        return {
            "embed": L.embed_specs(cfg),
            "enc_pos": {"table": P.ParamSpec((cfg.encoder_seq, D), ("pos", "embed"),
                                             init="normal", scale=0.02)},
            "dec_pos": {"table": P.ParamSpec((cfg.max_position, D), ("pos", "embed"),
                                             init="normal", scale=0.02)},
            "encoder": [_enc_block_specs(cfg) for _ in range(cfg.num_encoder_layers)],
            "enc_norm": L.layernorm_specs(D),
            "decoder": [_dec_block_specs(cfg) for _ in range(cfg.num_layers)],
            "final_norm": L.layernorm_specs(D),
        }

    def cache_specs(self, batch: int, max_len: int) -> list:
        cfg = self.cfg
        return [{"self": L.kv_cache_specs(cfg, batch, max_len),
                 "cross": L.kv_cache_specs(cfg, batch, cfg.encoder_seq)}
                for _ in range(cfg.num_layers)]

    def supports_paged(self) -> bool:
        """The encoder's output pins each row's cross-KV: dense rows only, as
        in the reference."""
        return False

    # ------------------------------------------------------------- encoder
    def encode(self, params, frames, shd=L.noop_shd):
        """frames (B, encoder_seq, D) -> encoder output (B, encoder_seq, D).
        Frames and positions are added in bf16 whatever the weights' dtype,
        as in the reference; the first residual add promotes to f32 weights."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        x = (frames.to(torch.bfloat16)
             + params["enc_pos"]["table"].to(torch.bfloat16))
        x = shd(x, L.RESIDUAL)
        sp = L.mesh_of(shd)
        h_axes, k_axes = L.head_axes(sp, cfg)
        for p in params["encoder"]:
            if sp is not None:
                p = sp.weights(p, _enc_block_specs(cfg))
            q, k, v = _qkv(p["mixer"], L.layernorm(p["ln1"], x, eps))
            k, v = L.kv_for_queries(sp, cfg, k, v, h_axes, k_axes)
            ctx = L.attention_full(q, k, v, causal=False, q_chunk=self.perf.q_chunk)
            x = x + L.reduce(sp, L.attn_out(p["mixer"], ctx), h_axes)
            x = x + L.mlp_apply(p["mlp"], L.layernorm(p["ln2"], x, eps), cfg, shd)
        return L.layernorm(params["enc_norm"], x, eps)

    # ------------------------------------------------------------- decoder
    def _dec_embed(self, params, tokens, positions, shd=L.noop_shd):
        x = L.embed_apply(params["embed"], tokens, self.cfg, shd)
        return x + params["dec_pos"]["table"][positions].to(x.dtype)

    def _dec_layer(self, p, x, enc_out, *, mode, cache=None, pos=None,
                   max_len=0, live=None, shd=L.noop_shd):
        """One decoder layer: causal self-attention, cross-attention to
        ``enc_out`` (decode reads the cached cross-KV instead), the MLP.
        Returns (x, the layer's new cache; None in mode "train").  A sharded
        step runs prefill and decode on this device's heads, the caches in
        the rules' layout."""
        cfg, eps, qc = self.cfg, self.cfg.norm_eps, self.perf.q_chunk
        sp = L.mesh_of(shd)
        if sp is not None:
            if mode not in ("prefill", "decode"):
                raise NotImplementedError(f"mode {mode!r} on a mesh")
            p = sp.weights(p, _dec_block_specs(cfg))
        h_axes, k_axes = L.head_axes(sp, cfg)
        q, k, v = _qkv(p["self"], L.layernorm(p["ln1"], x, eps))
        self_c = cross = None
        if mode == "decode":
            self_c, cross = cache["self"], cache["cross"]
            ctx = L.attend_decode(sp, cfg, q, k, v, self_c, pos,
                                  length=sp.kv_len if sp else 0, h_axes=h_axes,
                                  k_axes=k_axes, live=live)
        else:
            kq, vq = L.kv_for_queries(sp, cfg, k, v, h_axes, k_axes)
            ctx = L.attention_full(q, kq, vq, causal=True, q_chunk=qc)
            if mode == "prefill":
                # the reference's fresh self-KV keeps its spec dtype (bf16)
                empty = P.init(None, L.kv_cache_specs(cfg, x.shape[0], max_len,
                                                      heads=k.shape[2]), x.device)
                self_c = L.cache_to_mesh(sp, cfg, L.cache_write_prefill(empty, k, v),
                                         max_len, k_axes)
        x = x + L.reduce(sp, L.attn_out(p["self"], ctx), h_axes)

        h = L.layernorm(p["ln_x"], x, eps)
        qx = L._proj(h, p["cross"]["wq"])
        if mode == "decode" and sp is not None:
            # the cross-KV's slots may be split: the softmax merges across
            ctx = L.attend_decode(sp, cfg, qx, None, None, cross, pos,
                                  length=cfg.encoder_seq, h_axes=h_axes,
                                  k_axes=k_axes, write=False)
        else:
            if mode == "decode":
                ck, cv = cross["k"].to(qx.dtype), cross["v"].to(qx.dtype)
            else:
                ck = L._proj(enc_out, p["cross"]["wk"])
                cv = L._proj(enc_out, p["cross"]["wv"])
                if mode == "prefill":
                    cross = L.cache_to_mesh(sp, cfg, {"k": ck, "v": cv}, cfg.encoder_seq,
                                            k_axes)
                ck, cv = L.kv_for_queries(sp, cfg, ck, cv, h_axes, k_axes)
            ctx = L.attention_full(qx, ck, cv, causal=False, q_chunk=qc)
        x = x + L.reduce(sp, L.attn_out(p["cross"], ctx), h_axes)
        x = x + L.mlp_apply(p["mlp"], L.layernorm(p["ln2"], x, eps), cfg, shd)
        return x, None if mode == "train" else {"self": self_c, "cross": cross}

    def _decoder(self, params, x, enc_out, *, mode, caches=None, pos=None,
                 max_len=0, live=None, shd=L.noop_shd):
        """Every decoder layer; ``mode`` "train" (no caches, each layer
        under ``perf.remat``, as the reference rematerialises its decoder
        scan's body), "prefill" (fresh caches, the cross-KV projected from
        ``enc_out``) or "decode" (``caches`` updated in place).  Returns
        (x, caches; None in mode "train")."""
        if mode == "train":
            def layer(p, x, enc_out):
                return self._dec_layer(p, x, enc_out, mode="train", shd=shd)[0]

            for p in params["decoder"]:
                x = L.remat(self.perf.remat, layer, p, x, enc_out)
            return x, None
        new_caches = []
        for i, p in enumerate(params["decoder"]):
            x, c = self._dec_layer(p, x, enc_out, mode=mode,
                                   cache=None if caches is None else caches[i],
                                   pos=pos, max_len=max_len, live=live, shd=shd)
            new_caches.append(c)
        return x, new_caches

    def _logits(self, params, x, shd=L.noop_shd):
        x = L.layernorm(params["final_norm"], x, self.cfg.norm_eps)
        return L.unembed_logits(params["embed"], x, self.cfg, shd=shd)[:, 0]

    # ------------------------------------------------------------- public
    def loss(self, params, batch, shd=L.noop_shd):
        """batch: frames (B, encoder_seq, D), tokens (B,S), labels (B,S)
        (-1 = ignored).  Returns (mean next-token nll over the valid labels,
        metrics {"nll", "tokens", "aux": 0}), as the reference's loss."""
        tokens = batch["tokens"]
        enc = self.encode(params, batch["frames"], shd)
        x = self._dec_embed(params, tokens,
                            torch.arange(tokens.shape[1], device=tokens.device), shd)
        x = shd(x, L.RESIDUAL)
        x, _ = self._decoder(params, x, enc, mode="train", shd=shd)
        x = L.layernorm(params["final_norm"], x, self.cfg.norm_eps)
        nll, cnt = L.chunked_xent(params["embed"], x[:, :-1], batch["labels"][:, 1:],
                                  self.cfg, shd, chunk=self.perf.xent_chunk)
        loss = nll / cnt.clamp(min=1).to(nll.dtype)
        return loss, {"nll": nll, "tokens": cnt,
                      "aux": torch.zeros((), dtype=nll.dtype, device=nll.device)}

    def prefill(self, params, batch, max_len: int, true_len=None, shd=L.noop_shd):
        """batch: tokens (B,S), frames (B, encoder_seq, D).  Returns
        (logits (B,V) f32 at each row's last valid token, fresh caches).
        ``true_len`` (B,) counts the valid tokens of right-padded rows."""
        tokens = batch["tokens"]
        B, S = tokens.shape
        enc = self.encode(params, batch["frames"], shd)
        x = self._dec_embed(params, tokens, torch.arange(S, device=tokens.device), shd)
        x = shd(x, L.RESIDUAL)
        x, caches = self._decoder(params, x, enc, mode="prefill", max_len=max_len,
                                  shd=shd)
        idx = (torch.full((B,), S - 1, device=x.device) if true_len is None
               else (true_len.long() - 1).clamp(min=0))
        x_last = x[torch.arange(B, device=x.device), idx][:, None]
        return self._logits(params, x_last, shd), caches

    def decode_step(self, params, tokens, pos, caches, live=None, shd=L.noop_shd):
        """tokens (B,1), pos (B,) absolute positions.  ``live`` (B,) bool:
        False rows take no self-KV write.  Returns (logits (B,V) f32,
        caches)."""
        x = self._dec_embed(params, tokens, pos.long()[:, None], shd)
        x, caches = self._decoder(params, x, None, mode="decode", caches=caches,
                                  pos=pos, live=live, shd=shd)
        return self._logits(params, x, shd), caches
