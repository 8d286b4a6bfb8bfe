"""Decoder-only LM, dense GQA and MoE families (port of
``repro/models/transformer.py``).

Entry points, as in the reference:

  * ``prefill(params, inputs, cache=paged)`` — prompt -> (last logits,
    cache with the prompt K/V written through the block tables); without
    a paged cache, a fresh contiguous cache at ``max_len``;
  * ``prefill_chunk(...)`` — a C-token chunk, either written straight into
    the engine pool through per-row table snapshots (engine-direct mode)
    or appended to a contiguous cache;
  * ``decode_step(params, cache, tokens)`` — one token per row against a
    paged or contiguous cache.

Two KV layouts, both the reference's: the paged pool
``(L, n_blocks, block, nkv, d)`` with per-row block tables, and the
contiguous ``(L, B, max_len, nkv, d)`` with per-row positions (linear only:
sliding windows by masking; the reference's ring caches are not an engine
path and raise). Where JAX scans the layers and donates the cache across
the jit boundary, this port loops over the layer index and writes each
layer's cache slice IN PLACE, so a dispatch never copies the cache: the
cache dict a caller passes in is updated and handed back.

Attention goes through ``repro_torch.kernels.ops``: the hand-written CUDA
kernels for tensors on the card, the plain versions for CPU tensors. The
QKV / O / FFN / LM-head projections stay ``@`` (the JAX package leaves them
to XLA outside any Pallas kernel).

The dense and MoE families are ported; SSM, hybrid (kernel 6,
``ssd_scan``), enc-dec and M-RoPE raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
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
        if cfg.family in ("ssm", "hybrid"):
            raise _unported(f"the {cfg.family} family ({cfg.name}; kernel "
                            f"6, ssd_scan, and its paths)")
        if cfg.family not in ("dense", "moe") or cfg.is_encdec:
            raise _unported(f"the {cfg.family} family ({cfg.name})")
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
        }
        if c.n_experts > 0:
            layer["moe"] = moe_mod.moe_schema(c.d_model, c.d_ff, c.n_experts,
                                              c.gated_ffn)
        else:
            layer["mlp"] = ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                              c.mlp_bias)
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

    def _attn_decode(self, p: Dict, x: torch.Tensor, pos, ck, cv):
        """One-token attention against this layer's contiguous cache: write
        the token at ``pos`` (clamped to the row end, in place), attend
        the row's keys up to ``pos``."""
        q, k, v = self._qkv(p, x, pos[:, None])
        attn.cache_write_token(ck, cv, k, v, pos)
        o = kops.decode_attention(q, ck, cv, pos, window=self.cfg.swa_window)
        return self._out_proj(p, o)

    def _mlp_or_moe(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = self.norm(x, p["ln_mlp"])
        if c.n_experts > 0:
            out, _, _ = moe_mod.moe_apply(p["moe"], h, c.moe_top_k, c.act,
                                          c.gated_ffn)
            return out
        return ffn_mod.ffn_apply(p["mlp"], h, c.act, c.gated_ffn)

    @staticmethod
    def _layer(params: Dict, i: int) -> Dict:
        """Layer ``i``'s slice of the stacked layer params."""
        def pick(node):
            if isinstance(node, dict):
                return {k: pick(v) for k, v in node.items()}
            return node[i]
        return pick(params["layers"])

    def _dense_layer_chunk(self, p: Dict, x, q_pos, ck, cv, base,
                           block_tbl=None, lens=None, start=None):
        """Chunked-prefill layer body: write the chunk's K/V at
        [base, base+C) — through ``block_tbl`` into a block pool (columns
        past ``lens`` to the trash block), or into a contiguous cache from
        the host-side scalar ``start`` — and attend every query under its
        absolute position (``base``, per row, on the device)."""
        w = self.cfg.swa_window
        h = self.norm(x, p["ln_attn"])
        q, k, v = self._qkv(p["attn"], h, q_pos)
        if block_tbl is not None:
            attn.cache_write_chunk_paged(ck, cv, k, v, base, block_tbl,
                                         lens=lens)
            o = kops.chunk_attention_paged(q, ck, cv, block_tbl, base,
                                           window=w)
        else:
            if lens is not None:
                raise ValueError("column masking requires the paged path")
            attn.cache_write_chunk(ck, cv, k, v, start)
            o = kops.chunk_attention(q, ck, cv, base, window=w)
        x = x + self._out_proj(p["attn"], o)
        return x + self._mlp_or_moe(p, x)

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
    def init_cache(self, batch: int, max_len: int, kv_layout: str = "contig",
                   n_blocks: int = 0, block_size: int = 16,
                   ring: bool = False) -> Dict:
        """Zero cache with per-row positions ``pos`` (batch,).

        ``kv_layout="contig"``: each row owns a linear ``max_len`` slice,
        ``k``/``v`` (L, batch, max_len, nkv, d); sliding windows apply by
        masking (``ring=True``, the reference's windowed ring cache, is not
        an engine path and raises).

        ``kv_layout="paged"``: a pool of ``n_blocks`` ``block_size``-token
        blocks (L, n_blocks, block, nkv, d) shared by all rows, and a
        per-row ``block_tbl`` (batch, ceil(max_len/block)) whose entry 0
        is the reserved trash block."""
        c = self.cfg
        dev = self.device
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if ring and c.swa_window:
            raise _unported("the ring (sliding-window) KV cache")
        cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if kv_layout == "contig":
            shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.hd)
        else:
            max_blocks = -(-max_len // block_size)
            if n_blocks <= 0:
                n_blocks = batch * max_blocks + 1       # capacity == contig
            shape = (c.n_layers, n_blocks, block_size, c.n_kv_heads, c.hd)
            cache["block_tbl"] = torch.zeros((batch, max_blocks),
                                             dtype=torch.int32, device=dev)
        cache["k"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        cache["v"] = torch.zeros(shape, dtype=self.dtype, device=dev)
        return cache

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
            x = x + self._mlp_or_moe(p, x)
            ks.append(k)
            vs.append(v)
        return self._last(params, x, last_pos), torch.stack(ks), \
            torch.stack(vs)

    def prefill(self, params: Dict, inputs: Dict,
                last_pos: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Prompt -> (last-position logits (B, Vpad), cache). With a paged
        ``cache`` (from ``init_cache`` with allocated tables) the prompt K/V
        are written through its block tables, in place; otherwise into a
        fresh contiguous cache of ``max_len`` (default: the prompt length)
        positions per row."""
        tokens = inputs["tokens"]
        b, s = tokens.shape
        logits, k, v = self.prefill_kv(params, tokens, last_pos)
        if cache is not None and "block_tbl" in cache:
            attn.cache_write_prefill_paged(cache["k"], cache["v"], k, v,
                                           cache["block_tbl"])
        else:
            cache = self.init_cache(b, max_len or s)
            cache["k"][:, :, :s] = k.to(self.dtype)
            cache["v"][:, :, :s] = v.to(self.dtype)
        cache["pos"] = torch.full_like(cache["pos"], s)
        return logits, cache

    def prefill_chunk(self, params: Dict, cache: Dict, tokens: torch.Tensor,
                      base: IntLike, last_pos: Optional[torch.Tensor] = None,
                      block_tbl: Optional[torch.Tensor] = None,
                      lens: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Incremental prefill: a C-token chunk per row at absolute
        positions [base, base+C); queries attend the whole prefix under
        per-position masks, so consecutive chunks equal one full prefill.

        Two destinations, as the engine uses them: with ``block_tbl`` the
        ENGINE's pool, each of the B rows written through its own table row
        (engine-direct mode; ``lens`` masks columns >= lens into the trash
        block; the per-slot ``pos`` update is the caller's); without it a
        contiguous cache (one scalar ``base`` for every row), whose ``pos``
        becomes ``base + C``. Returns (logits at ``last_pos`` (default: last
        chunk column), the cache, updated in place)."""
        x = self.embed(params, tokens)
        b, cl = tokens.shape
        direct = block_tbl is not None
        base_t = torch.as_tensor(base, device=x.device).long()
        if not direct and ("block_tbl" in cache or base_t.ndim != 0):
            raise ValueError("without block_tbl the cache must be contiguous "
                             "and the base one scalar")
        bases = base_t.expand(b) if base_t.ndim == 0 else base_t
        q_pos = bases[:, None] + torch.arange(cl, device=x.device)[None, :]
        start = None if direct else int(base)
        for i in range(self.cfg.n_layers):
            x = self._dense_layer_chunk(self._layer(params, i), x, q_pos,
                                        cache["k"][i], cache["v"][i], bases,
                                        block_tbl=block_tbl, lens=lens,
                                        start=start)
        if not direct:
            cache["pos"] = torch.full_like(cache["pos"], int(base) + cl)
        return self._last(params, x, last_pos), cache

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """One new token for every row. tokens: (B, 1). Writes the tokens'
        K/V into the cache (paged or contiguous) in place; returns (logits
        (B,1,Vpad), cache with ``pos`` advanced)."""
        x = self.embed(params, tokens)
        pos = cache["pos"]
        tbl = cache.get("block_tbl")
        for i in range(self.cfg.n_layers):
            p = self._layer(params, i)
            h = self.norm(x, p["ln_attn"])
            ck, cv = cache["k"][i], cache["v"][i]
            if tbl is not None:
                a = self._attn_decode_paged(p["attn"], h, pos, ck, cv, tbl)
            else:
                a = self._attn_decode(p["attn"], h, pos, ck, cv)
            x = x + a
            x = x + self._mlp_or_moe(p, x)
        x = self.norm(x, params["final_norm"])
        cache["pos"] = cache["pos"] + 1
        return self.logits(params, x), cache
