"""Whisper-style encoder-decoder LM (port of ``repro/models/encdec.py``).

The audio frontend (log-mel + conv) is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_enc, d_model). The
backbone is real: a bidirectional encoder, a causal decoder with
cross-attention, LayerNorm, GELU, biases everywhere, absolute sinusoidal
positions (no RoPE), tied embeddings.

Parameters carry the reference's names and ``(d_in, d_out)`` layouts
(``encoder``, ``decoder``, ``enc_final_ln``, ``final_norm``, ``embed``),
stacked on the layer axis, so ``models/convert.py`` copies a JAX tree
across as it is.

Attention goes through ``repro_torch.kernels.ops`` wherever a port kernel
computes the function (the hand-written CUDA kernels for tensors on the
card, their plain versions for CPU tensors): encoder self-attention and
every cross-attention (queries against the S_enc encoder keys, unmasked)
through ``flash_attention(causal=False)``, the full prefill's decoder
self-attention through ``flash_attention(causal=True)``, the chunked
prefill's through ``chunk_attention`` and decode's through
``decode_attention``. (The reference reaches a Pallas kernel only in the
chunk, its other calls being its plain attention, which the plain versions
here reproduce.)

The cache is contiguous only: ``k``/``v`` (L, B, max_len, nkv, d) for the
decoder's self-attention, ``ck``/``cv`` (L, B, S_enc, nkv, d) for its
cross-attention, ``pos`` (B,). Writes update the cache tensors IN PLACE,
as the decoder-only ``LM`` does.

Tensor parallelism (``sharder`` with a mesh) runs on the decoder-only
model's pieces (``transformer.TensorParallel``): encoder self-, decoder
self- and cross-attention split by whole heads (``bq`` / ``bk`` / ``bv``
with them, ``wo`` row-parallel and ``bo`` added after the sum), the FFN
column- then row-parallel (``b_up`` split, ``b_down`` after the sum), the
tied embedding and logits vocab-parallel, the sinusoidal positions
replicated, and the self and cross caches by heads (or by sequence under
``cache_seq``, each leaf by its own length). Under the ``seq`` rule the
prefill cuts the encoder's and the decoder's residual streams by
sequence, each by its own length, as the decoder-only model does
(``transformer`` module docstring): the encoder's output is gathered
whole once for the cross K/V, and a cross-attention whose heads are
whole on every rank runs on the rank's slice of the decoder positions.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (ParamDef, lm_cross_entropy,
                                       make_norm, norm_schema,
                                       remat, sinusoidal_positions,
                                       stack_schema, unbind_layers)
from repro_torch.models.transformer import TensorParallel
from repro_torch.sharding.rules import Axes, Sharder


class EncDecLM(TensorParallel):
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 remat: bool = True, sharder: Optional[Sharder] = None,
                 batch_axes: Axes = None):
        if not cfg.is_encdec:
            raise ValueError(f"{cfg.name} has no encoder layers")
        self.cfg = cfg
        # per-layer activation checkpointing in ``loss`` (the reference's
        # ``remat``)
        self.remat = remat
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.norm = make_norm(cfg.norm)
        self._schema = self._build_schema()
        self.sharder = sharder or Sharder()
        # mesh axes the caller split the batch rows over (the steps set it)
        self.batch_axes = batch_axes
        self._tp_layout()

    # -- schema ------------------------------------------------------------
    def _attn_schema(self) -> Dict:
        c = self.cfg
        return {
            "wq": ParamDef((c.d_model, c.n_heads * c.hd), ("embed", "heads")),
            "wk": ParamDef((c.d_model, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wv": ParamDef((c.d_model, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wo": ParamDef((c.n_heads * c.hd, c.d_model), ("heads", "embed")),
            "bq": ParamDef((c.n_heads * c.hd,), ("heads",), "zeros"),
            "bk": ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros"),
            "bv": ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros"),
            "bo": ParamDef((c.d_model,), ("embed",), "zeros"),
        }

    def _enc_layer_schema(self) -> Dict:
        c = self.cfg
        return {
            "ln1": norm_schema(c.norm, c.d_model),
            "attn": self._attn_schema(),
            "ln2": norm_schema(c.norm, c.d_model),
            "mlp": ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                      c.mlp_bias),
        }

    def _dec_layer_schema(self) -> Dict:
        c = self.cfg
        return {
            "ln1": norm_schema(c.norm, c.d_model),
            "self_attn": self._attn_schema(),
            "ln2": norm_schema(c.norm, c.d_model),
            "cross_attn": self._attn_schema(),
            "ln3": norm_schema(c.norm, c.d_model),
            "mlp": ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                      c.mlp_bias),
        }

    def _build_schema(self) -> Dict:
        c = self.cfg
        return {
            "embed": {"tok": ParamDef((c.padded_vocab, c.d_model),
                                      ("vocab", "embed"))},
            "encoder": stack_schema(self._enc_layer_schema(),
                                    c.n_encoder_layers),
            "enc_final_ln": norm_schema(c.norm, c.d_model),
            "decoder": stack_schema(self._dec_layer_schema(), c.n_layers),
            "final_norm": norm_schema(c.norm, c.d_model),
        }

    # -- helpers -------------------------------------------------------------
    @staticmethod
    def _layer(stack: Dict, i: int) -> Dict:
        """Layer ``i``'s slice of stacked layer params."""
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node[i]
        return pick(stack)

    def _heads(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], n, self.cfg.hd).contiguous()

    def _proj_q(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        return self._heads(x @ p["wq"] + p["bq"], self.n_heads_local)

    def _proj_kv(self, p: Dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.n_kv_local
        return (self._heads(x @ p["wk"] + p["bk"], n),
                self._heads(x @ p["wv"] + p["bv"], n))

    def _pe(self, n: int, device) -> torch.Tensor:
        return sinusoidal_positions(n, self.cfg.d_model, device).to(
            self.dtype)

    def _cross(self, p: Dict, h: torch.Tensor, ck: torch.Tensor,
               cv: torch.Tensor, sp=None) -> torch.Tensor:
        """Cross-attention sub-block: the decoder rows (ln2 applied by the
        caller) against the encoder's K/V, unmasked; with ``sp``, ``h``
        holds the whole sequence and the output this rank's slice."""
        o = kops.flash_attention(self._proj_q(p, h), self._attn_kv(ck),
                                 self._attn_kv(cv), causal=False)
        return self._out_proj(p, o, sp)

    def _cross_cached(self, p: Dict, h: torch.Tensor, ck: torch.Tensor,
                      cv: torch.Tensor) -> torch.Tensor:
        """``_cross`` against the cache's ``ck`` / ``cv`` (one decoder
        token per row): on a cross cache cut by sequence, the decode
        kernel with its log-sum-exp output at the slice's last local
        position (every key visible: the unmasked function) and the
        slices' partials merged (``_split_attention``)."""
        if not self._kv_cut("ck"):
            return self._cross(p, h, ck, cv)
        last = torch.full((h.shape[0],), ck.shape[1] - 1, dtype=torch.int32,
                          device=h.device)
        return self._out_proj(p, self._split_attention(
            self._proj_q(p, h), ck, cv, last, every_head=True))

    def _tail(self, p: Dict, h: torch.Tensor, sp=None) -> torch.Tensor:
        """The decoder layer's MLP sub-block (residual included)."""
        return h + self._ffn_block(p["mlp"], h, p["ln3"], sp)

    # -- encoder -------------------------------------------------------------
    def _enc_layer(self, p: Dict, x: torch.Tensor, sp=None) -> torch.Tensor:
        """One encoder layer; with the sequence cut over ``sp``, ``x`` in
        and out is this rank's slice of the frames."""
        a = self._enter(self.norm(self._sp_whole(x, sp), p["ln1"]),
                        self._heads_ax, sp)
        k, v = self._proj_kv(p["attn"], a)
        o = kops.flash_attention(self._proj_q(p["attn"], a), self._attn_kv(k),
                                 self._attn_kv(v), causal=False)
        x = x + self._out_proj(p["attn"], o, sp)
        return x + self._ffn_block(p["mlp"], x, p["ln2"], sp)

    def encode(self, params: Dict, frames: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """frames: (B, S_enc, d_model), the stubbed frontend's output.
        ``train`` (``loss``): each layer under ``remat``. The ``seq`` rule
        cuts the frames by sequence (``_seq_axes`` of S_enc); the output
        is whole."""
        sp = self._seq_axes(frames.shape[0], frames.shape[1])
        x = frames.to(self.dtype)
        x = self._sp_cut(x + self._pe(x.shape[1], x.device), sp)
        n = self.cfg.n_encoder_layers
        layers = (unbind_layers(params["encoder"]) if train else
                  [self._layer(params["encoder"], i) for i in range(n)])
        for p in layers:
            x = remat(train and self.remat, self._enc_layer, p, x, sp)
        return self.norm(self._sp_whole(x, sp), params["enc_final_ln"])

    def cross_kv(self, params: Dict, enc_out: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Every decoder layer's cross-attention K/V of ``enc_out``, stacked
        (L, B, S_enc, nkv, d): the cache's ``ck``/``cv`` without running a
        decoder token, exactly as ``prefill`` projects them (the chunked
        prefill warms a group's cross cache with it once)."""
        ks, vs = zip(*(self._proj_kv(self._layer(params["decoder"], i)
                                     ["cross_attn"], enc_out)
                       for i in range(self.cfg.n_layers)))
        return torch.stack(ks), torch.stack(vs)

    # -- decoder ---------------------------------------------------------------
    def _dec_layer(self, p: Dict, x: torch.Tensor, enc_out: torch.Tensor,
                   sp=None):
        """One decoder layer over whole prompts: (x, k, v, ck, cv); with
        the sequence cut over ``sp``, ``x`` in and out is this rank's
        slice (a cross-attention whose heads are whole runs on it)."""
        ax = self._heads_ax
        a = self._enter(self.norm(self._sp_whole(x, sp), p["ln1"]), ax, sp)
        k, v = self._proj_kv(p["self_attn"], a)
        o = kops.flash_attention(self._proj_q(p["self_attn"], a),
                                 self._attn_kv(k), self._attn_kv(v),
                                 causal=True)
        x = x + self._out_proj(p["self_attn"], o, sp)
        # under the cut (training needs the encoder cut with the decoder)
        # ``enc_out`` comes gathered, and its gather sums the gradient
        ck, cv = self._proj_kv(p["cross_attn"], self._enter(enc_out, ax, sp))
        xsp = sp if ax is not None else None
        x = x + self._cross(p["cross_attn"], self._enter(
            self.norm(self._sp_whole(x, xsp), p["ln2"]), ax, xsp), ck, cv,
            xsp)
        return self._tail(p, x, sp), k, v, ck, cv

    def _decoder_full(self, params: Dict, tokens: torch.Tensor,
                      enc_out: torch.Tensor, collect_kv: bool = True,
                      sp=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The decoder over whole prompts: (final-normed x, the stacked
        self- and cross-attention K/V ``k``/``v``/``ck``/``cv``); with
        ``collect_kv=False`` (``loss``) no K/V, each layer under
        ``remat``. With the sequence cut over ``sp``, x is this rank's
        slice of the positions."""
        c = self.cfg
        x = self.embed(params, tokens, sp)
        x = x + self._sp_cut(self._pe(tokens.shape[1], x.device)[None], sp)
        kv: Dict[str, list] = {"k": [], "v": [], "ck": [], "cv": []}
        layers = (unbind_layers(params["decoder"]) if not collect_kv else
                  [self._layer(params["decoder"], i)
                   for i in range(c.n_layers)])
        for p in layers:
            if not collect_kv:
                x = remat(self.remat,
                          lambda pl, h, e: self._dec_layer(pl, h, e, sp)[0],
                          p, x, enc_out)
                continue
            x, *kvs = self._dec_layer(p, x, enc_out, sp)
            for key, t in zip(("k", "v", "ck", "cv"), kvs):
                kv[key].append(t)
        x = self.norm(x, params["final_norm"])
        if not collect_kv:
            return x, {}
        return x, {key: torch.stack(ts) for key, ts in kv.items()}

    def _last(self, params: Dict, x: torch.Tensor,
              last_pos: Optional[torch.Tensor], sp=None) -> torch.Tensor:
        return self.logits(params, self._sp_last(x, last_pos, sp))[:, 0, :]

    # -- public: loss / caches / prefill / decode --------------------------------
    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The reference's ``EncDecLM.loss``: decoder cross entropy (the
        mean over ``mask``) of ``tokens`` against ``targets`` given encoder
        frames ``embeds``. Encoder self-attention, decoder causal
        self-attention and cross attention all train through the flash
        kernels on the card (``FlashAttentionFn``)."""
        return lm_cross_entropy(self._train_logits(params, batch),
                                batch["targets"], batch.get("mask"),
                                self.cfg.vocab)

    def loss_shard(self, params: Dict, batch: Dict, count: float,
                   tokens: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """This rank's share of a microbatch's ``loss`` in a mesh step, as
        ``LM.loss_shard``: its rows' summed NLL over ``count`` (over its
        slice of the positions under the ``seq`` rule), as (the
        objective, its value); ``tokens`` is unused (no MoE)."""
        sp = self.train_seq_axes(batch)
        nll = self._nll_sum(self._train_logits(params, batch, sp), batch,
                            sp) / count
        return nll, nll.detach()

    def _train_logits(self, params: Dict, batch: Dict, sp=None
                      ) -> torch.Tensor:
        """The decoder's logits, of this rank's slice of the positions
        where the sequence is cut over ``sp``; the encoder must then be
        cut over the same axes (each rank's objective is its slice's, so
        an encoder kept whole would sum its gradient once too often)."""
        frames = batch["embeds"]
        if sp != self._seq_axes(frames.shape[0], frames.shape[1]):
            raise NotImplementedError(
                f"{self.cfg.name}: training with the decoder's sequence cut "
                f"over {sp} and the encoder's frames cut otherwise")
        enc_out = self.encode(params, frames, train=True)
        x, _ = self._decoder_full(params, batch["tokens"], enc_out,
                                  collect_kv=False, sp=sp)
        self.residual_shape = tuple(x.shape)
        return self.logits(params, x, sp)

    def init_cache(self, batch: int, max_len: int, s_enc: int) -> Dict:
        """Zero cache: self-attention ``k``/``v`` (L, batch, max_len, nkv,
        d), cross-attention ``ck``/``cv`` (L, batch, s_enc, nkv, d) and
        per-row positions ``pos`` (batch,); nkv is this rank's KV heads,
        or, on caches cut by sequence (``cache_seq``, the self and the cross
        cache each where the axes divide its length), every KV head of its
        slice of the positions. The leaves' lengths go to
        ``kv_lengths``."""
        c = self.cfg
        dev = self.device
        self_shape = (c.n_layers, batch, self.seq_slice(max_len)[1],
                      self.kv_heads_of(max_len), c.hd)
        cross_shape = (c.n_layers, batch, self.seq_slice(s_enc)[1],
                       self.kv_heads_of(s_enc), c.hd)
        self.kv_lengths = {"k": max_len, "v": max_len, "ck": s_enc,
                           "cv": s_enc}
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(self_shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(self_shape, dtype=self.dtype, device=dev),
            "ck": torch.zeros(cross_shape, dtype=self.dtype, device=dev),
            "cv": torch.zeros(cross_shape, dtype=self.dtype, device=dev),
        }

    def cache_specs(self) -> Dict:
        """Logical sharding names for cache entries (the reference's tree;
        ``pos`` is per row here)."""
        kv = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
        return {"pos": (), "k": kv, "v": kv, "ck": kv, "cv": kv}

    def prefill_kv(self, params: Dict, inputs: Dict,
                   last_pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Dict]:
        """``inputs``: ``embeds`` (B, S_enc, d_model) frames and ``tokens``
        (B, S_dec) -> (logits at ``last_pos`` (default: last column), the
        stacked ``k``/``v`` (L,B,S_dec,nkv,d) and ``ck``/``cv``
        (L,B,S_enc,nkv,d)). Right-padded rows are exact under causal
        masking (the engine's batched prefill)."""
        enc_out = self.encode(params, inputs["embeds"])
        tokens = inputs["tokens"]
        sp = self._seq_axes(tokens.shape[0], tokens.shape[1])
        x, kv = self._decoder_full(params, tokens, enc_out, sp=sp)
        self.residual_shape = tuple(x.shape)
        return self._last(params, x, last_pos, sp), kv

    def prefill(self, params: Dict, inputs: Dict,
                max_len: Optional[int] = None,
                last_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Prompt -> (logits (B, Vpad), a fresh cache of ``max_len``
        (default: the decoder prompt's length) positions per row, ``pos``
        at the prompt's length)."""
        b, s = inputs["tokens"].shape
        logits, kv = self.prefill_kv(params, inputs, last_pos)
        length = max_len or s
        cache = self.init_cache(b, length, kv["ck"].shape[2])
        for key, val in kv.items():
            if self._seq_ax is None:
                cache[key][:, :, :val.shape[2]] = val.to(self.dtype)
                continue
            # cut by sequence: the rank's slice of the positions
            cache[key] = self.kv_to_cache(
                val.to(self.dtype), length if key in ("k", "v") else None)
        cache["pos"].fill_(s)
        return logits, cache

    def prefill_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                      base: int, last_pos: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Chunked decoder prefill: ``tokens`` (B, C) at decoder positions
        [base, base+C) of every row. The cross cache ``ck``/``cv`` must be
        resident (``cross_kv``), so a chunk runs only the decoder body; over
        consecutive chunks this equals one full ``prefill``. Writes the
        chunk's K/V into the cache in place and sets ``pos`` to base + C;
        returns (logits at ``last_pos`` (default: last chunk column), the
        cache)."""
        c = self.cfg
        if self._seq_ax is not None:
            raise ValueError("chunked prefill needs whole sequences, not a "
                             "cache cut by sequence (cache_seq)")
        b, cl = tokens.shape
        x = self.embed(params, tokens)
        x = x + self._pe(base + cl, x.device)[base:][None]
        bases = torch.full((b,), base, dtype=torch.int32, device=x.device)
        for i in range(c.n_layers):
            p = self._layer(params["decoder"], i)
            ck, cv = cache["k"][i], cache["v"][i]
            a = self.norm(x, p["ln1"])
            k, v = self._proj_kv(p["self_attn"], a)
            attn.cache_write_chunk(ck, cv, k, v, base)
            o = kops.chunk_attention(self._proj_q(p["self_attn"], a), ck, cv,
                                     bases)
            x = x + self._out_proj(p["self_attn"], o)
            x = x + self._cross(p["cross_attn"], self.norm(x, p["ln2"]),
                                cache["ck"][i], cache["cv"][i])
            x = self._tail(p, x)
        cache["pos"].fill_(base + cl)
        return self._last(params, self.norm(x, params["final_norm"]),
                          last_pos), cache

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """One decoder token per row, tokens (B, 1), at each row's ``pos``
        (the sinusoid clamped to the cache's last position, as the
        reference takes it). Writes the tokens' K/V in place; returns
        (logits (B, 1, Vpad), the cache with ``pos`` advanced)."""
        c = self.cfg
        pos = cache["pos"]
        max_pos = cache["k"].shape[2]
        if self._kv_cut("k"):
            max_pos = self._whole_length(max_pos)[1]
        x = self.embed(params, tokens)
        pe = self._pe(max_pos, x.device)
        x = x + pe[torch.clamp(pos.long(), max=max_pos - 1)][:, None]
        for i in range(c.n_layers):
            p = self._layer(params["decoder"], i)
            ck, cv = cache["k"][i], cache["v"][i]
            a = self.norm(x, p["ln1"])
            k, v = self._proj_kv(p["self_attn"], a)
            o = self._cached_attention(self._proj_q(p["self_attn"], a), k, v,
                                       pos, ck, cv, key="k")
            x = x + self._out_proj(p["self_attn"], o)
            x = x + self._cross_cached(p["cross_attn"],
                                       self.norm(x, p["ln2"]),
                                       cache["ck"][i], cache["cv"][i])
            x = self._tail(p, x)
        x = self.norm(x, params["final_norm"])
        cache["pos"] = pos + 1
        return self.logits(params, x), cache
