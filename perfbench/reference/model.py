"""Plain reference of the dense decoder the benchmark's configurations run:
float32 PyTorch with TF32 off, no kernels, no cache, no batching.

Per layer: a norm (RMSNorm, or LayerNorm with its bias), q / k / v / o
projections with optional biases, rotary positions on the half-split pairs
(i, i + d/2) with the angles in float64, causal softmax attention where
each group of n_heads / n_kv_heads query heads reads one K/V head, the
residual, a second norm, the gated SiLU (or plain) FFN, the residual; then
the final norm and the head (the tied embedding or its own matrix). That
is the configuration as the repo's trunk runs it; the configuration file
lists where it departs from the published model.

The reference works a whole context (prompt and served tokens) layer by
layer: each layer's weights are upcast when that layer runs, and queries go
through attention in blocks, so it fits beside the bf16 weights at full
width. ``precision="fp8"`` is the control: every product of a weight and an
activation takes both through float8_e4m3fn first (a scale per output
column of the weight and per token of the activation), as an fp8 serving
path would; norms, softmax and the residual stay in float32.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence, Tuple

import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """TF32 off for the reference's products (restored after)."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) rounded through float8_e4m3fn with one scale per
    slice along ``dim`` (its largest magnitude maps to 448)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Reference:
    """The reference over one weight tree. ``model`` is a configuration
    file's ``model`` block."""

    def __init__(self, model: Dict, weights: Dict, precision: str = "fp32",
                 q_block: int = 512):
        assert precision in ("fp32", "fp8"), precision
        self.m = model
        self.w = weights
        self.fp8 = precision == "fp8"
        self.q_block = q_block
        self.d = int(model["d_model"])
        self.nh = int(model["n_heads"])
        self.nkv = int(model["n_kv_heads"])
        self.hd = int(model.get("head_dim") or self.d // self.nh)
        self.vocab = int(model["vocab"])
        self.eps = float(model.get("norm_eps", 1e-5))
        self.theta = float(model["rope_theta"])

    # -- pieces ------------------------------------------------------------
    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        if self.fp8:
            return _fp8(x, -1) @ _fp8(w, 0)
        return x @ w

    def _norm(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        w = p["w"].float()
        if self.m.get("norm", "rmsnorm") == "rmsnorm":
            return x * torch.rsqrt((x * x).mean(-1, keepdim=True)
                                   + self.eps) * w
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + self.eps) * w
        return y + p["b"].float() if "b" in p else y

    def _rope(self, x: torch.Tensor) -> torch.Tensor:
        """x: (n, heads, hd); position i at row i."""
        n, half = x.shape[0], self.hd // 2
        inv = 1.0 / self.theta ** (torch.arange(
            half, dtype=torch.float64, device=x.device) / half)
        ang = torch.arange(n, dtype=torch.float64, device=x.device)[:, None] \
            * inv[None]
        cos = ang.cos().float()[:, None, :]
        sin = ang.sin().float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
        """Causal GQA; q (n, nh, hd), k / v (n, nkv, hd) -> (n, nh*hd)."""
        n, g = q.shape[0], self.nh // self.nkv
        kk = k.permute(1, 2, 0)                      # (nkv, hd, n)
        vv = v.permute(1, 0, 2)                      # (nkv, n, hd)
        out = torch.empty((n, self.nh, self.hd), dtype=torch.float32,
                          device=q.device)
        scale = self.hd ** -0.5
        cols = torch.arange(n, device=q.device)
        for s in range(0, n, self.q_block):
            e = min(n, s + self.q_block)
            # (nkv, g * rows, hd): the g query heads of a K/V head together
            qb = q[s:e].reshape(e - s, self.nkv, g, self.hd)
            qb = qb.permute(1, 2, 0, 3).reshape(self.nkv, g * (e - s),
                                                self.hd)
            sc = torch.bmm(qb, kk[:, :, :e]) * scale
            rows = torch.arange(s, e, device=q.device).repeat(g)
            sc.masked_fill_(cols[None, None, :e] > rows[None, :, None],
                            float("-inf"))
            pr = torch.softmax(sc, dim=-1)
            ob = torch.bmm(pr, vv[:, :e])            # (nkv, g*rows, hd)
            ob = ob.reshape(self.nkv, g, e - s, self.hd).permute(2, 0, 1, 3)
            out[s:e] = ob.reshape(e - s, self.nh, self.hd)
        return out.reshape(n, self.nh * self.hd)

    def _layer(self, x: torch.Tensor, p: Dict) -> torch.Tensor:
        n = x.shape[0]
        h = self._norm(x, p["ln_attn"])
        a = p["attn"]
        q, k, v = self._mm(h, a["wq"]), self._mm(h, a["wk"]), \
            self._mm(h, a["wv"])
        if "bq" in a:
            q, k, v = q + a["bq"].float(), k + a["bk"].float(), \
                v + a["bv"].float()
        q = self._rope(q.reshape(n, self.nh, self.hd))
        k = self._rope(k.reshape(n, self.nkv, self.hd))
        o = self._mm(self._attention(q, k, v.reshape(n, self.nkv, self.hd)),
                     a["wo"])
        if "bo" in a:
            o = o + a["bo"].float()
        x = x + o
        h = self._norm(x, p["ln_mlp"])
        f = p["mlp"]
        up = self._mm(h, f["w_up"])
        if "b_up" in f:
            up = up + f["b_up"].float()
        act = torch.nn.functional.silu if self.m.get("act", "silu") == \
            "silu" else (lambda t: torch.nn.functional.gelu(
                t, approximate="tanh"))
        hid = act(self._mm(h, f["w_gate"])) * up if "w_gate" in f \
            else act(up)
        y = self._mm(hid, f["w_down"])
        if "b_down" in f:
            y = y + f["b_down"].float()
        return x + y

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(n, vocab) float32 logits of hidden rows ``x`` (normed here)."""
        h = self._norm(x, self.w["final_norm"])
        head = self.w["lm_head"] if "lm_head" in self.w \
            else self.w["embed"]["tok"].T
        out = torch.empty((h.shape[0], self.vocab), dtype=torch.float32,
                          device=h.device)
        step = 32768
        for s in range(0, self.vocab, step):
            e = min(self.vocab, s + step)
            out[:, s:e] = self._mm(h, head[:, s:e])
        return out

    # -- entry ---------------------------------------------------------------
    @torch.no_grad()
    def served_logits(self, seqs: Sequence[Tuple[Sequence[int],
                                                 Sequence[int]]]
                      ) -> List[torch.Tensor]:
        """For each (prompt, served tokens): the logits (len(served),
        vocab) at the positions that chose each served token (the prompt's
        last position, then each served token but the last)."""
        dev = self.w["embed"]["tok"].device
        xs, picks = [], []
        for prompt, served in seqs:
            ids = list(prompt) + list(served)[:-1]
            t = torch.tensor(ids, dtype=torch.long, device=dev)
            xs.append(self.w["embed"]["tok"][t].float())
            picks.append(torch.arange(len(prompt) - 1, len(ids),
                                      device=dev))
        layers = self.w["layers"]
        n_layers = int(self.m["n_layers"])
        with fp32_exact():
            for i in range(n_layers):
                p = _pick(layers, i)
                xs = [self._layer(x, p) for x in xs]
            return [self._logits(x[sel]) for x, sel in zip(xs, picks)]


def _pick(node, i: int):
    if isinstance(node, dict):
        return {k: _pick(v, i) for k, v in node.items()}
    return node[i]
