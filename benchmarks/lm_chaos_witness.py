"""Why a random-init LM stack of the seed is chaotic at full width: a
witness on the CPU, in the JAX reference and in the PyTorch port on the
same weights.

Both packages' ``models/layers.py::_init`` scale a weight by
1/sqrt(shape[-2]).  For ``wq`` (D, H, Dh) that is 1/sqrt(H) and for
``wk`` / ``wv`` (D, K, Dh) 1/sqrt(K), not 1/sqrt(D): at qwen2-0.5b's
widths (D = 896, H = 14, K = 2) q and k come out ~8× and ~21× larger
than unit-variance rows would give, the attention scores have a std of
order 10², and the softmax picks one key per row.  A hard max is
discontinuous where two scores meet, so a change of 1e-6 in the input
grows layer by layer; the Mamba2 stack has no attention and does not.

The script builds qwen2-0.5b at its published widths with its depth cut
to each of ``--layers`` and its vocabulary cut to ``--vocab`` (the
vocabulary only sizes the embedding and the head), draws the weights
with the reference's init (``--seed``), carries them to the port with
``params_from_numpy``, and prints for each depth, in float32:

  * the layer-0 attention scores' std and the share of query rows
    (position >= 8) whose largest softmax weight exceeds 0.99;
  * max|Δ logits| of a prefill of 4 × 129 tokens when the embedding
    table is scaled by 1 + 1e-6 (``chip_smoke.py`` phase 11's probe),

in the reference and in the port.  Run:

    PYTHONPATH=src JAX_PLATFORMS=cpu python benchmarks/lm_chaos_witness.py
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.models.layers as JL
from repro.configs import get_config as jconfig
from repro.models import get_api as jget
from repro_torch.configs import get_config as tconfig
from repro_torch.models import get_api as tget
from repro_torch.models import params_from_numpy

B, S, CACHE = 4, 129, 192
NUDGE = 1 + 1e-6
HARD = 0.99


def score_stats(p, cfg, toks, rope) -> tuple[float, float]:
    """Layer 0's causal attention scores (q·k/√Dh after the norm, the
    q/k biases and rope) from numpy weights: (std, share of rows whose
    softmax puts more than HARD on one key)."""
    x = p["embed"]["table"][toks].astype(np.float64)
    x = x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)
    x = x * p["norm1"]["scale"][0]
    a = {k: v[0].astype(np.float64) for k, v in p["attn"].items()}
    q = np.einsum("bsd,dhe->bshe", x, a["wq"]) + a.get("bq", 0.0)
    k = np.einsum("bsd,dke->bske", x, a["wk"]) + a.get("bk", 0.0)
    q, k = rope(q.astype(np.float32)), rope(k.astype(np.float32))
    G = cfg.n_heads // cfg.n_kv_heads
    k = np.repeat(k, G, axis=2)
    s = np.einsum("bshe,bthe->bhst", q, k) / np.sqrt(cfg.d_head)
    causal = np.tril(np.ones((S, S), bool))
    std = float(s[..., causal].std())
    s = np.where(causal, s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    hard = float((w.max(-1)[..., 8:] > HARD).mean())
    return std, hard


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--layers", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    toks = np.random.default_rng(args.seed + 1).integers(
        0, args.vocab, (B, S)).astype(np.int32)
    pos = np.arange(S)
    for n in args.layers:
        jcfg = dataclasses.replace(jconfig(args.arch), num_layers=n,
                                   vocab_size=args.vocab, dtype=jnp.float32)
        tcfg = dataclasses.replace(tconfig(args.arch), num_layers=n,
                                   vocab_size=args.vocab, dtype=torch.float32)
        japi, tapi = jget(jcfg), tget(tcfg, device="cpu")
        params = jax.tree.map(np.asarray, japi.init(
            jax.random.PRNGKey(args.seed))[0])
        nudged = dict(params, embed={"table": params["embed"]["table"]
                                     * np.float32(NUDGE)})
        jprefill = jax.jit(lambda p, t: japi.prefill(
            p, t, japi.init_cache(B, CACHE))[1])
        runs = {"reference": lambda p: np.asarray(jprefill(
                    jax.tree.map(jnp.asarray, p), jnp.asarray(toks))),
                "port": lambda p: tapi.prefill(
                    params_from_numpy(p), torch.from_numpy(toks),
                    tapi.init_cache(B, CACHE))[1].numpy()}
        rope = lambda a: np.asarray(JL.rope(jnp.asarray(a), jnp.asarray(pos),
                                            jcfg.rope_theta))
        port_init = _numpy_tree(tapi.init(
            torch.Generator().manual_seed(args.seed))[0])
        row = {"arch": args.arch, "layers": n, "vocab": args.vocab}
        for name, p in (("reference_init", params), ("port_init", port_init)):
            row[name] = dict(zip(("score_std", "hard_max_share"),
                                 score_stats(p, jcfg, toks, rope)))
        for name, run in runs.items():
            a, b = run(params), run(nudged)
            row[name] = {"nudge_max_abs": float(np.abs(a - b).max()),
                         "logits_max_abs": float(np.abs(a).max())}
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
