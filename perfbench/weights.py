"""Weights drawn from ``--seed`` on the device, in the tree the port's ``LM``
takes (its parameter names and ``(d_in, d_out)`` layouts, layers stacked on
a leading axis), in the type they are served in.

The tree is built here from the configuration's sizes, not asked of the
program; the harness checks that the program's ``param_shapes()`` agrees.
Each matrix is one ``normal_`` call on its whole stacked leaf (std
``init_std``); norm weights are ones and biases zeros. The reference reads
these same tensors.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def padded_vocab(model: Dict) -> int:
    m = int(model.get("vocab_pad_multiple", 128))
    return -(-int(model["vocab"]) // m) * m


def tree_shapes(model: Dict) -> Dict:
    """The parameter tree's shapes (a nested dict of tuples)."""
    d, L = int(model["d_model"]), int(model["n_layers"])
    nh, nkv = int(model["n_heads"]), int(model["n_kv_heads"])
    hd = int(model.get("head_dim") or d // nh)
    ff, vp = int(model["d_ff"]), padded_vocab(model)
    layernorm = model.get("norm", "rmsnorm") == "layernorm"

    def norm(stack: Tuple[int, ...] = ()) -> Dict:
        out = {"w": stack + (d,)}
        if layernorm:
            out["b"] = stack + (d,)
        return out

    attn = {"wq": (L, d, nh * hd), "wk": (L, d, nkv * hd),
            "wv": (L, d, nkv * hd), "wo": (L, nh * hd, d)}
    if model.get("qkv_bias"):
        attn.update(bq=(L, nh * hd), bk=(L, nkv * hd), bv=(L, nkv * hd))
    if model.get("o_bias"):
        attn["bo"] = (L, d)
    mlp = {"w_up": (L, d, ff), "w_down": (L, ff, d)}
    if model.get("gated_ffn", True):
        mlp["w_gate"] = (L, d, ff)
    if model.get("mlp_bias"):
        mlp.update(b_up=(L, ff), b_down=(L, d))
    tree = {"embed": {"tok": (vp, d)}, "final_norm": norm(),
            "layers": {"ln_attn": norm((L,)), "attn": attn,
                       "ln_mlp": norm((L,)), "mlp": mlp}}
    if not model.get("tie_embeddings", False):
        tree["lm_head"] = (d, vp)
    return tree


def make_weights(model: Dict, seed: int, device, dtype: torch.dtype,
                 std: float) -> Dict:
    """Draw the tree on ``device`` from one generator seeded with ``seed``,
    leaves in sorted key order."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))

    def build(node, name: str):
        if isinstance(node, dict):
            return {k: build(node[k], k) for k in sorted(node)}
        t = torch.empty(node, dtype=dtype, device=device)
        if name == "w" and len(node) <= 2:        # a norm's scale
            return t.fill_(1.0)
        if name.startswith("b"):                   # a bias
            return t.zero_()
        return t.normal_(0.0, std, generator=gen)

    return build(tree_shapes(model), "")


def count(tree: Dict) -> int:
    if isinstance(tree, dict):
        return sum(count(v) for v in tree.values())
    return tree.numel()


def shapes_of(tree: Dict) -> Dict:
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    return tuple(tree.shape)
