"""Decoder-only LM: dense GQA, MoE, SSM (Mamba2) and hybrid (Zamba2)
families (port of ``repro/models/transformer.py``).

Entry points, as in the reference:

  * ``prefill(params, inputs, cache=paged)`` — prompt -> (last logits,
    cache with the prompt K/V written through the block tables); without
    a paged cache, a fresh contiguous cache at ``max_len``;
  * ``prefill_chunk(...)`` — a C-token chunk, either written straight into
    the engine pool through per-row table snapshots (engine-direct mode)
    or appended to a contiguous cache (attention families only, as in the
    reference);
  * ``decode_step(params, cache, tokens)`` — one token per row against a
    paged or contiguous cache, or one recurrent step.

Two KV layouts, both the reference's: the paged pool
``(L, n_blocks, block, nkv, d)`` with per-row block tables, and the
contiguous ``(L, B, max_len, nkv, d)`` with per-row positions (linear only:
sliding windows by masking; the reference's ring caches are not an engine
path and raise). The SSM and hybrid families carry recurrent state instead,
contiguous only: ``conv`` (L, B, K-1, d_inner+2N) in the model dtype and
``ssd`` (L, B, nheads, head_dim, N) in fp32, plus, for the hybrid, ``ak`` /
``av`` (n_apps, B, max_len, nkv, d) per shared-block application. Where JAX
scans the layers (the hybrid in groups of ``hybrid_period``) and donates
the cache across the jit boundary, this port loops over the layer index
and writes each layer's cache slice IN PLACE, so a dispatch never copies
the cache: the cache dict a caller passes in is updated and handed back.

Attention and the SSD scan go through ``repro_torch.kernels.ops``: the
hand-written CUDA kernels for tensors on the card, the plain versions for
CPU tensors. With ``kv_probe`` armed (the engine arms it in sanitize mode
on the paged layout, as the reference does) the paged decode and chunk
calls also return the KV sanitizer's probe, the largest |K| / |V| each row
may read; the model keeps every layer's on the device, and ``take_probe``
hands the caller their maximum once per dispatch. The QKV / O / FFN / SSM
in-out / LM-head projections stay ``@`` (the JAX package leaves them to
XLA outside any Pallas kernel).

Enc-dec and M-RoPE raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, dtype_of, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, apply_rope, init_params,
                                       make_norm, norm_schema, param_count,
                                       schema_shapes, stack_schema)

IntLike = Union[int, torch.Tensor]


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: {what} is not ported yet (see ROADMAP.md, port "
        f"queue)")


RECURRENT = ("ssm", "hybrid")       # families whose cache is SSM state
STATE_KEYS = ("conv", "ssd")        # per-row recurrent state, no seq axis


class LM:
    def __init__(self, cfg: ArchConfig, device: DeviceLike = None,
                 ssd_chunk: int = 128, kv_probe: bool = False):
        if cfg.family not in ("dense", "moe") + RECURRENT or cfg.is_encdec:
            raise _unported(f"the {cfg.family} family ({cfg.name})")
        if cfg.m_rope:
            raise _unported("M-RoPE inputs (VLM)")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.hybrid_period:
            raise ValueError(f"{cfg.name}: {cfg.n_layers} trunk layers are "
                             f"not whole groups of {cfg.hybrid_period}")
        self.cfg = cfg
        self.ssd_chunk = ssd_chunk
        # KV sanitizer probe on the paged attention calls; their (B, nh)
        # maxima since the last ``take_probe``, on the device
        self.kv_probe = kv_probe
        self._probes: List[torch.Tensor] = []
        self.device = resolve_device(device)
        self.dtype = dtype_of(cfg.dtype)
        self.norm = make_norm(cfg.norm)
        self._schema = self._build_schema()

    # ------------------------------------------------------------------ #
    # schema / params
    # ------------------------------------------------------------------ #
    def _attn_schema(self, in_dim: Optional[int] = None) -> Dict:
        c = self.cfg
        d_in = in_dim or c.d_model
        s = {
            "wq": ParamDef((d_in, c.n_heads * c.hd), ("embed", "heads")),
            "wk": ParamDef((d_in, c.n_kv_heads * c.hd),
                           ("embed", "kv_heads")),
            "wv": ParamDef((d_in, c.n_kv_heads * c.hd),
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

    def _dense_layer_schema(self) -> Dict:
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
        return layer

    def _mamba_layer_schema(self) -> Dict:
        c = self.cfg
        return {
            "ln": norm_schema(c.norm, c.d_model),
            "mixer": ssm_mod.mamba2_schema(c.d_model, c.d_inner, c.ssm_state,
                                           c.ssm_heads, c.conv_width),
        }

    def _shared_block_schema(self) -> Dict:
        """Zamba2 shared transformer block: attention over concat(x, x0)."""
        c = self.cfg
        return {
            "ln_attn": norm_schema(c.norm, 2 * c.d_model),
            "attn": self._attn_schema(in_dim=2 * c.d_model),
            "ln_mlp": norm_schema(c.norm, c.d_model),
            "mlp": ffn_mod.ffn_schema(c.d_model, c.d_ff, c.gated_ffn,
                                      c.mlp_bias),
        }

    def _build_schema(self) -> Dict:
        c = self.cfg
        s = {
            "embed": {"tok": ParamDef((c.padded_vocab, c.d_model),
                                      ("vocab", "embed"))},
            "final_norm": norm_schema(c.norm, c.d_model),
        }
        if c.family in RECURRENT:
            s["layers"] = stack_schema(self._mamba_layer_schema(), c.n_layers)
            if c.family == "hybrid":
                s["shared"] = self._shared_block_schema()
        else:
            s["layers"] = stack_schema(self._dense_layer_schema(), c.n_layers)
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

    def _probed(self, out):
        """An attention call's output; with the probe armed the call also
        returned its (B, nh) probe, kept on the device for
        ``take_probe``."""
        if not self.kv_probe:
            return out
        o, pmax = out
        self._probes.append(pmax)
        return o

    def take_probe(self) -> Optional[torch.Tensor]:
        """The largest readable |K| / |V| over every probed call since the
        last take (a 0-dim fp32 tensor on the device; None if none ran),
        and clear the record."""
        if not self._probes:
            return None
        worst = torch.cat([p.reshape(-1) for p in self._probes]).amax()
        self._probes = []
        return worst

    def _attn_decode_paged(self, p: Dict, x: torch.Tensor, pos, ck, cv,
                           block_tbl):
        """One-token attention against this layer's block pool: write the
        token through the block table (in place), attend over the pages."""
        q, k, v = self._qkv(p, x, pos[:, None])
        attn.cache_write_token_paged(ck, cv, k, v, pos, block_tbl)
        o = self._probed(kops.decode_attention_paged(
            q, ck, cv, block_tbl, pos, window=self.cfg.swa_window,
            probe=self.kv_probe))
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
            # the probe covers the columns ``lens`` keeps: pad columns
            # write to the trash block, so the tail of a reused block past
            # the prompt's end may still hold poison that no real query
            # reads (the reference probes pad columns too, and raises
            # there: a deliberate difference, ROADMAP.md section C)
            o = self._probed(kops.chunk_attention_paged(
                q, ck, cv, block_tbl, base, window=w, probe=self.kv_probe,
                probe_cols=lens))
        else:
            if lens is not None:
                raise ValueError("column masking requires the paged path")
            attn.cache_write_chunk(ck, cv, k, v, start)
            o = kops.chunk_attention(q, ck, cv, base, window=w)
        x = x + self._out_proj(p["attn"], o)
        return x + self._mlp_or_moe(p, x)

    def _mamba_layer_fwd(self, p: Dict, x: torch.Tensor):
        c = self.cfg
        h = self.norm(x, p["ln"])
        y, st = ssm_mod.mamba2_prefill(
            p["mixer"], h, c.d_inner, c.ssm_state, c.ssm_heads,
            c.ssm_head_dim, chunk=self.ssd_chunk)
        return x + y, st

    def _mamba_layer_step(self, p: Dict, x: torch.Tensor, conv: torch.Tensor,
                          ssd: torch.Tensor) -> torch.Tensor:
        """One-token Mamba2 layer; writes the layer's new ``conv`` / ``ssd``
        state into the cache slices it was given, in place."""
        c = self.cfg
        h = self.norm(x, p["ln"])
        y, st = ssm_mod.mamba2_step(
            p["mixer"], h, ssm_mod.SSMState(conv, ssd), c.d_inner,
            c.ssm_state, c.ssm_heads, c.ssm_head_dim)
        conv.copy_(st.conv)
        ssd.copy_(st.ssd)
        return x + y

    def _shared_block_fwd(self, p: Dict, x, x0, positions):
        """Zamba2 shared block on concat(x, x0); returns (x, k, v)."""
        c = self.cfg
        h = self.norm(torch.cat([x, x0], dim=-1), p["ln_attn"])
        a, k, v = self._attn_full(p["attn"], h, positions)
        x = x + a
        h = self.norm(x, p["ln_mlp"])
        return x + ffn_mod.ffn_apply(p["mlp"], h, c.act, c.gated_ffn), k, v

    def _shared_block_decode(self, p: Dict, x, x0, pos, ck, cv):
        c = self.cfg
        h = self.norm(torch.cat([x, x0], dim=-1), p["ln_attn"])
        x = x + self._attn_decode(p["attn"], h, pos, ck, cv)
        h = self.norm(x, p["ln_mlp"])
        return x + ffn_mod.ffn_apply(p["mlp"], h, c.act, c.gated_ffn)

    def _run_trunk_full(self, params: Dict, x: torch.Tensor, positions
                        ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence pass over all layers (prefill). Returns (x, the
        stacked per-layer state): ``k``/``v`` for the attention families;
        ``conv``/``ssd`` for SSM and hybrid, plus the hybrid's shared-block
        K/V ``ak``/``av``, one entry per application (it fires after every
        ``hybrid_period`` trunk layers, as the reference's grouped scan
        does)."""
        c = self.cfg
        state: Dict[str, list] = {}
        if c.family in RECURRENT:
            fire = c.shared_attn_positions()
            x0 = x
            for i in range(c.n_layers):
                x, st = self._mamba_layer_fwd(self._layer(params, i), x)
                state.setdefault("conv", []).append(st.conv)
                state.setdefault("ssd", []).append(st.ssd)
                if i in fire:
                    x, k, v = self._shared_block_fwd(params["shared"], x, x0,
                                                     positions)
                    state.setdefault("ak", []).append(k)
                    state.setdefault("av", []).append(v)
        else:
            for i in range(c.n_layers):
                p = self._layer(params, i)
                h = self.norm(x, p["ln_attn"])
                a, k, v = self._attn_full(p["attn"], h, positions)
                x = x + a
                x = x + self._mlp_or_moe(p, x)
                state.setdefault("k", []).append(k)
                state.setdefault("v", []).append(v)
        return x, {key: torch.stack(vals) for key, vals in state.items()}

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
        is the reserved trash block.

        SSM / hybrid (contig only; paged raises ``ValueError``): ``conv``
        (L, batch, K-1, d_inner+2N) in the model dtype, ``ssd`` (L, batch,
        nheads, head_dim, N) fp32, and for the hybrid ``ak``/``av``
        (n_apps, batch, max_len, nkv, d), one per shared-block
        application."""
        c = self.cfg
        dev = self.device
        if kv_layout not in ("contig", "paged"):
            raise ValueError(f"unknown kv_layout {kv_layout!r}")
        if kv_layout == "paged" and c.family in RECURRENT:
            raise ValueError("paged KV requires attention caches")
        if ring and c.swa_window:
            raise _unported("the ring (sliding-window) KV cache")
        cache = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
        if c.family in RECURRENT:
            cache["conv"] = torch.zeros(
                (c.n_layers, batch, c.conv_width - 1,
                 c.d_inner + 2 * c.ssm_state), dtype=self.dtype, device=dev)
            cache["ssd"] = torch.zeros(
                (c.n_layers, batch, c.ssm_heads, c.ssm_head_dim,
                 c.ssm_state), dtype=torch.float32, device=dev)
            if c.family == "hybrid":
                shape = (len(c.shared_attn_positions()), batch, max_len,
                         c.n_kv_heads, c.hd)
                cache["ak"] = torch.zeros(shape, dtype=self.dtype, device=dev)
                cache["av"] = torch.zeros(shape, dtype=self.dtype, device=dev)
            return cache
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
                   ) -> Tuple[torch.Tensor, Dict]:
        """Prompt (B, S) -> (logits at ``last_pos`` (default: last column),
        the stacked per-layer state the prompt leaves, as the reference's
        ``aux``: ``k``/``v`` (L,B,S,nkv,d) for the attention families;
        ``conv``/``ssd`` (L,B,...) and, hybrid, ``ak``/``av``
        (n_apps,B,S,nkv,d)). Right-padded rows are exact for attention
        under causal masking; recurrent state runs through pad columns,
        so the engine gives those families exact-length groups."""
        x = self.embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        x, aux = self._run_trunk_full(params, x, positions)
        return self._last(params, x, last_pos), aux

    def prefill(self, params: Dict, inputs: Dict,
                last_pos: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """Prompt -> (last-position logits (B, Vpad), cache). With a paged
        ``cache`` (from ``init_cache`` with allocated tables) the prompt K/V
        are written through its block tables, in place; otherwise into a
        fresh contiguous cache of ``max_len`` (default: the prompt length)
        positions per row (SSM / hybrid: the final recurrent state, and the
        hybrid's shared-block K/V)."""
        tokens = inputs["tokens"]
        b, s = tokens.shape
        logits, aux = self.prefill_kv(params, tokens, last_pos)
        if cache is not None and "block_tbl" in cache:
            attn.cache_write_prefill_paged(cache["k"], cache["v"], aux["k"],
                                           aux["v"], cache["block_tbl"])
        else:
            cache = self.init_cache(b, max_len or s)
            for key, val in aux.items():
                if key in STATE_KEYS:           # recurrent state: whole
                    cache[key].copy_(val)
                else:                           # K/V: the prompt's positions
                    cache[key][:, :, :s] = val.to(self.dtype)
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
        if self.cfg.family in RECURRENT:
            raise ValueError("chunked prefill requires attention caches "
                             f"({self.cfg.family} carries recurrent state)")
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
        K/V (paged or contiguous) or the layers' new recurrent state into
        the cache in place; returns (logits (B,1,Vpad), cache with ``pos``
        advanced)."""
        x = self.embed(params, tokens)
        if self.cfg.family in RECURRENT:
            x = self._decode_recurrent(params, cache, x, cache["pos"])
        else:
            x = self._decode_attention(params, cache, x, cache["pos"])
        x = self.norm(x, params["final_norm"])
        cache["pos"] = cache["pos"] + 1
        return self.logits(params, x), cache

    def _decode_attention(self, params: Dict, cache: Dict, x: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        """Dense / MoE layers, each writing its token's K/V through the
        block tables (paged) or at ``pos`` (contiguous)."""
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
        return x

    def _decode_recurrent(self, params: Dict, cache: Dict, x: torch.Tensor,
                          pos: torch.Tensor) -> torch.Tensor:
        """Mamba2 steps over the trunk, each layer's ``conv``/``ssd`` state
        updated in place; the hybrid's shared block, after each group,
        writes and attends its application's contiguous ``ak``/``av`` at
        ``pos``."""
        fire = self.cfg.shared_attn_positions()
        x0 = x
        for i in range(self.cfg.n_layers):
            x = self._mamba_layer_step(self._layer(params, i), x,
                                       cache["conv"][i], cache["ssd"][i])
            if i in fire:
                g = fire.index(i)
                x = self._shared_block_decode(params["shared"], x, x0, pos,
                                              cache["ak"][g], cache["av"][g])
        return x
