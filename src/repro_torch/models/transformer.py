"""Decoder-only LM, dense GQA family (port of ``repro/models/transformer.py``).

Entry points, as in the reference:

  * ``prefill(params, inputs, cache=paged)`` — prompt -> (last logits,
    cache with the prompt K/V written through the block tables);
  * ``prefill_chunk(...)`` — a C-token chunk written straight into the
    engine pool through per-row table snapshots (engine-direct mode);
  * ``decode_step(params, cache, tokens)`` — one token per row against the
    paged cache.

The KV pool keeps the reference's stacked ``(L, n_blocks, block, nkv, d)``
layout. Where JAX scans the layers and donates the pool across the jit
boundary, this port loops over the layer index and writes each layer's
pool slice IN PLACE, so a dispatch never copies the pool: the cache dict a
caller passes in is updated and handed back.

Attention goes through ``repro_torch.kernels.ops``: the hand-written CUDA
kernels for tensors on the card, the plain versions for CPU tensors. The
QKV / O / FFN / LM-head projections stay ``@`` (the JAX package leaves them
to XLA outside any Pallas kernel).

Only the dense family on the paged layout is ported: MoE, SSM, hybrid,
enc-dec and the contiguous cache raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import (ParamDef, apply_rope, init_params,
                                       make_norm, norm_schema, param_count,
                                       schema_shapes, stack_schema)

IntLike = Union[int, torch.Tensor]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (see ROADMAP.md, port "
        f"queue)")


class LM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None):
        if cfg.family != "dense" or cfg.n_experts > 0 or cfg.is_encdec:
            raise _unported(f"the {cfg.family} family "
                            f"({cfg.name}; kernels 4-6 and their paths)")
        if cfg.m_rope:
            raise _unported("M-RoPE inputs (VLM)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.norm = make_norm(cfg.norm)
        self._schema = self._build_schema()

    # ------------------------------------------------------------------ #
    # schema / params
    # ------------------------------------------------------------------ #
    def _attn_schema(self) -> Dict:
        c = self.cfg
        s = {
            "wq": ParamDef((c.d_model, c.n_heads * c.hd), ("embed", "heads")),
            "wk": ParamDef((c.d_model, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wv": ParamDef((c.d_model, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wo": ParamDef((c.n_heads * c.hd, c.d_model), ("heads", "embed")),
        }
        if c.qkv_bias:
            s["bq"] = ParamDef((c.n_heads * c.hd,), ("heads",), "zeros")
            s["bk"] = ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros")
            s["bv"] = ParamDef((c.n_kv_heads * c.hd,), ("kv_heads",), "zeros")
        if c.o_bias:
            s["bo"] = ParamDef((c.d_model,), ("embed",), "zeros")
        return s

    def _build_schema(self) -> Dict:
        c = self.cfg
        layer = {
            "ln_attn": norm_schema(c.norm, c.d_model),
            "attn": self._attn_schema(),
            "ln_mlp": norm_schema(c.norm, c.d_model),
            "mlp": ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                      c.mlp_bias),
        }
        s = {
            "embed": {"tok": ParamDef((c.padded_vocab, c.d_model),
                                      ("vocab", "embed"))},
            "final_norm": norm_schema(c.norm, c.d_model),
            "layers": stack_schema(layer, c.n_layers),
        }
        if not c.tie_embeddings:
            s["lm_head"] = ParamDef((c.d_model, c.padded_vocab),
                                    ("embed", "vocab"))
        return s

    def init(self, seed: int = 0,
             generator: Optional[torch.Generator] = None) -> Dict:
        """Random params on the model's device from a seeded generator."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return init_params(self._schema, gen, self.dtype, self.device)

    def param_shapes(self) -> Dict:
        return schema_shapes(self._schema)

    def param_count(self) -> int:
        return param_count(self._schema)

    # ------------------------------------------------------------------ #
    # embedding / logits
    # ------------------------------------------------------------------ #
    def embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"]["tok"][tokens.long()]

    def logits(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"]["tok"].T
        return x @ params["lm_head"]

    def sample_greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy next token over the un-padded vocab."""
        return torch.argmax(logits[..., :self.cfg.vocab], dim=-1)

    # ------------------------------------------------------------------ #
    # attention layer bodies
    # ------------------------------------------------------------------ #
    def _qkv(self, p: Dict, x: torch.Tensor, positions: torch.Tensor):
        c = self.cfg
        q = x @ p["wq"]
        k = x @ p["wk"]
        v = x @ p["wv"]
        if "bq" in p:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        b, s = x.shape[0], x.shape[1]
        q = q.reshape(b, s, c.n_heads, c.hd)
        k = k.reshape(b, s, c.n_kv_heads, c.hd)
        v = v.reshape(b, s, c.n_kv_heads, c.hd)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        return q.contiguous(), k.contiguous(), v.contiguous()

    def _out_proj(self, p: Dict, o: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        o = o.reshape(o.shape[0], o.shape[1], c.n_heads * c.hd) @ p["wo"]
        if "bo" in p:
            o = o + p["bo"]
        return o

    def _attn_full(self, p: Dict, x: torch.Tensor, positions):
        """Full-sequence causal attention; returns (out, k, v)."""
        q, k, v = self._qkv(p, x, positions)
        o = kops.flash_attention(q, k, v, causal=True,
                                 window=self.cfg.swa_window)
        return self._out_proj(p, o), k, v

    def _attn_decode_paged(self, p: Dict, x: torch.Tensor, pos, ck, cv,
                           block_tbl):
        """One-token attention against this layer's block pool: write the
        token through the block table (in place), attend over the pages."""
        q, k, v = self._qkv(p, x, pos[:, None])
        attn.cache_write_token_paged(ck, cv, k, v, pos, block_tbl)
        o = kops.decode_attention_paged(q, ck, cv, block_tbl, pos,
                                        window=self.cfg.swa_window)
        return self._out_proj(p, o)

    def _mlp(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x, p["ln_mlp"])
        return ffn_mod.ffn_apply(p["mlp"], h, self.cfg.act,
                                 self.cfg.gated_ffn)

    @staticmethod
    def _layer(params: Dict, i: int) -> Dict:
        """Layer ``i``'s slice of the stacked layer params."""
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node[i]
        return pick(params["layers"])

    def _dense_layer_chunk(self, p: Dict, x, q_pos, ck, cv, base,
                           block_tbl, lens=None):
        """Chunked-prefill layer body against a block pool: write the
        chunk's K/V at [base, base+C) through ``block_tbl`` (columns past
        ``lens`` to the trash block), attend every query under its
        absolute position."""
        h = self.norm(x, p["ln_attn"])
        q, k, v = self._qkv(p["attn"], h, q_pos)
        attn.cache_write_chunk_paged(ck, cv, k, v, base, block_tbl,
                                     lens=lens)
        o = kops.chunk_attention_paged(q, ck, cv, block_tbl, base,
                                       window=self.cfg.swa_window)
        x = x + self._out_proj(p["attn"], o)
        return x + self._mlp(p, x)

    def _last(self, params: Dict, x: torch.Tensor,
              last_pos: Optional[torch.Tensor]) -> torch.Tensor:
        x = self.norm(x, params["final_norm"])
        if last_pos is None:
            last = x[:, -1:, :]
        else:
            rows = torch.arange(x.shape[0], device=x.device)
            last = x[rows, last_pos.long()][:, None, :]
        return self.logits(params, last)[:, 0, :]

    # ------------------------------------------------------------------ #
    # public: caches / prefill / decode
    # ------------------------------------------------------------------ #
    def init_cache(self, batch: int, max_len: int, kv_layout: str = "paged",
                   n_blocks: int = 0, block_size: int = 16) -> Dict:
        """Zero paged cache: a pool of ``n_blocks`` ``block_size``-token
        blocks (L, n_blocks, block, nkv, d) shared by all rows, a per-row
        ``block_tbl`` (batch, ceil(max_len/block)) whose entry 0 is the
        reserved trash block, and per-row positions ``pos`` (batch,)."""
        if kv_layout != "paged":
            raise _unported("the contiguous KV layout")
        c = self.cfg
        dev = self.device
        max_blocks = -(-max_len // block_size)
        if n_blocks <= 0:
            n_blocks = batch * max_blocks + 1       # capacity == contig
        shape = (c.n_layers, n_blocks, block_size, c.n_kv_heads, c.hd)
        return {
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=self.dtype, device=dev),
            "v": torch.zeros(shape, dtype=self.dtype, device=dev),
            "block_tbl": torch.zeros((batch, max_blocks), dtype=torch.int32,
                                     device=dev),
        }

    def prefill_kv(self, params: Dict, tokens: torch.Tensor,
                   last_pos: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Prompt (B, S) -> (logits at ``last_pos`` (default: last column),
        stacked K (L,B,S,nkv,d), stacked V). Right-padded rows are exact
        under causal masking: pad columns never reach real ones."""
        x = self.embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        ks, vs = [], []
        for i in range(self.cfg.n_layers):
            p = self._layer(params, i)
            h = self.norm(x, p["ln_attn"])
            a, k, v = self._attn_full(p["attn"], h, positions)
            x = x + a
            x = x + self._mlp(p, x)
            ks.append(k)
            vs.append(v)
        return self._last(params, x, last_pos), torch.stack(ks), \
            torch.stack(vs)

    def prefill(self, params: Dict, inputs: Dict,
                last_pos: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """Prompt -> (last-position logits (B, Vpad), paged cache). The
        prompt K/V are written through ``cache``'s block tables (from
        ``init_cache`` with allocated tables), in place."""
        if cache is None or "block_tbl" not in cache:
            raise _unported("prefill into a fresh contiguous cache")
        tokens = inputs["tokens"]
        logits, k, v = self.prefill_kv(params, tokens, last_pos)
        attn.cache_write_prefill_paged(cache["k"], cache["v"], k, v,
                                       cache["block_tbl"])
        cache["pos"] = torch.full_like(cache["pos"], tokens.shape[1])
        return logits, cache

    def prefill_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                      base: IntLike, block_tbl: torch.Tensor,
                      last_pos: Optional[torch.Tensor] = None,
                      lens: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Incremental prefill straight into the engine's pool: a C-token
        chunk per row at absolute positions [base, base+C), each of the B
        rows written through its own ``block_tbl`` row (engine-direct mode
        of the reference; the cache's own tables are not used). ``lens``
        masks columns >= lens into the trash block; the per-slot ``pos``
        update is the caller's. Returns (logits at ``last_pos`` (default:
        last chunk column), the cache, updated in place)."""
        x = self.embed(params, tokens)
        b, cl = tokens.shape
        base_t = torch.as_tensor(base, device=x.device).long()
        bases = base_t.expand(b) if base_t.ndim == 0 else base_t
        q_pos = bases[:, None] + torch.arange(cl, device=x.device)[None, :]
        for i in range(self.cfg.n_layers):
            x = self._dense_layer_chunk(self._layer(params, i), x, q_pos,
                                        cache["k"][i], cache["v"][i], bases,
                                        block_tbl, lens=lens)
        return self._last(params, x, last_pos), cache

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """One new token for every row. tokens: (B, 1). Writes the tokens'
        K/V into the pool in place; returns (logits (B,1,Vpad), cache with
        ``pos`` advanced)."""
        if "block_tbl" not in cache:
            raise _unported("decode on a contiguous cache")
        x = self.embed(params, tokens)
        pos = cache["pos"]
        tbl = cache["block_tbl"]
        for i in range(self.cfg.n_layers):
            p = self._layer(params, i)
            h = self.norm(x, p["ln_attn"])
            x = x + self._attn_decode_paged(p["attn"], h, pos, cache["k"][i],
                                            cache["v"][i], tbl)
            x = x + self._mlp(p, x)
        x = self.norm(x, params["final_norm"])
        cache["pos"] = cache["pos"] + 1
        return self.logits(params, x), cache
