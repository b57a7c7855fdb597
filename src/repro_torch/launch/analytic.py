"""Loop-aware analytic FLOP/byte accounting for the roofline.

A verbatim copy of the JAX package's ``launch/analytic.py`` (pure Python),
held bit-equal to it by ``tests/test_torch_sharding.py``. Its counts are
of the JAX programs' work on the TPU production mesh; nothing here is a
measurement of the port or of an H100.

XLA:CPU's ``compiled.cost_analysis()`` counts while-loop (lax.scan) bodies
ONCE (verified in tests/test_roofline.py), so raw HLO numbers undercount any
scanned program by ~the trip count. The dry-run therefore reports BOTH the
raw cost_analysis numbers and these analytic totals; the roofline terms use
the analytic ones.

FLOPs are exact matmul counts (2MNK per dot, x3 for backward, +1 forward for
full-remat recompute). Bytes are a first-order HBM traffic model: parameter
reads per pass + activation carries + cache/state traffic, per device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

__all__ = ["analytic_cost", "CostBreakdown"]


@dataclasses.dataclass
class CostBreakdown:
    flops: float                 # global FLOPs per step
    hbm_bytes: float             # per-DEVICE HBM traffic per step
    detail: Dict[str, float]

    def to_dict(self):
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "detail": self.detail}


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[name]


def _attn_layer_flops(cfg, tokens: float, ctx: float, causal: bool = True) -> float:
    # NOTE: the chunked attention computes the full (Sq x Skv) score grid —
    # fully-masked KV blocks are NOT skipped — so causal does not halve the
    # executed FLOPs. (Skipping them is a recorded hillclimb candidate.)
    del causal
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    proj = 2.0 * tokens * d * (h + 2 * kv) * hd + 2.0 * tokens * h * hd * d
    sc = 2.0 * tokens * ctx * h * hd * 2.0          # scores + values
    return proj + sc


def _mlp_layer_flops(cfg, tokens: float) -> float:
    if cfg.d_ff <= 0:
        return 0.0
    mats = 3.0 if cfg.act in ("swiglu", "geglu") else 2.0
    return 2.0 * tokens * cfg.d_model * cfg.d_ff * mats


def _moe_layer_flops(cfg, tokens: float) -> float:
    f = cfg.moe_d_ff or cfg.d_ff
    router = 2.0 * tokens * cfg.d_model * cfg.n_experts
    # capacity-padded expert compute (what actually executes)
    routed = tokens * cfg.top_k * cfg.capacity_factor
    expert = 2.0 * routed * cfg.d_model * f * 3.0
    return router + expert


def _ssd_layer_flops(cfg, tokens: float) -> float:
    d, di = cfg.d_model, cfg.ssm_d_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, p = cfg.ssm_nheads, cfg.ssm_headdim
    q = cfg.ssm_chunk
    proj = 2.0 * tokens * d * (2 * di + 2 * g * n + h)
    conv = 2.0 * tokens * (di + 2 * g * n) * cfg.ssm_conv
    # intra-chunk: CB^T scores (q per row) + apply; inter-chunk state ops
    intra = 2.0 * tokens * q * h * (n + p)
    states = 2.0 * tokens * h * p * n * 2.0
    out = 2.0 * tokens * di * d
    return proj + conv + intra + states + out


def _logits_flops(cfg, tokens: float) -> float:
    return 2.0 * tokens * cfg.d_model * cfg.padded_vocab


def analytic_cost(cfg, shape, chips: int) -> CostBreakdown:
    kind = shape.kind
    b, s = shape.global_batch, shape.seq_len
    pb = _dtype_bytes(cfg.param_dtype)

    if kind == "decode":
        tokens = float(b)           # one new token per sequence
        ctx = float(s)
    else:
        tokens = float(b) * s
        ctx = float(s)

    per_layer = {"attn": 0.0, "ssm": 0.0, "mlp": 0.0, "moe": 0.0}
    n_kinds = {"attn": 0, "ssm": 0, "mlp": 0, "moe": 0}
    for mixer, ffn in cfg.layer_kinds():
        n_kinds[mixer] += 1
        if ffn in ("mlp", "moe"):
            n_kinds[ffn] += 1

    fl_attn = (_attn_layer_flops(cfg, tokens, ctx) if kind != "decode" else
               2.0 * tokens * cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
               + 2.0 * tokens * cfg.n_heads * cfg.head_dim * cfg.d_model
               + 2.0 * tokens * ctx * cfg.n_heads * cfg.head_dim * 2.0)
    fl_ssm = _ssd_layer_flops(cfg, tokens) if any(m == "ssm" for m, _ in cfg.layer_kinds()) else 0.0
    if kind == "decode" and fl_ssm:
        # decode SSD: state update + emit only
        fl_ssm = (2.0 * tokens * cfg.d_model * (2 * cfg.ssm_d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_nheads)
                  + 2.0 * tokens * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 2.0
                  + 2.0 * tokens * cfg.ssm_d_inner * cfg.d_model)
    fl_mlp = _mlp_layer_flops(cfg, tokens)
    fl_moe = _moe_layer_flops(cfg, tokens)

    fwd = (n_kinds["attn"] * fl_attn + n_kinds["ssm"] * fl_ssm +
           n_kinds["mlp"] * fl_mlp + n_kinds["moe"] * fl_moe)
    if cfg.is_encdec and kind != "decode":
        enc_tokens = float(b) * cfg.enc_seq
        enc = cfg.n_enc_layers * (
            _attn_layer_flops(cfg, enc_tokens, float(cfg.enc_seq), causal=False)
            + _mlp_layer_flops(cfg, enc_tokens))
        # cross attention in each decoder layer
        cross = cfg.n_layers * (
            2.0 * tokens * cfg.d_model * 3 * cfg.n_heads * cfg.head_dim
            + 2.0 * tokens * cfg.enc_seq * cfg.n_heads * cfg.head_dim * 2.0)
        fwd += enc + cross
    if cfg.is_encdec and kind == "decode":
        cross = cfg.n_layers * (
            2.0 * tokens * cfg.d_model * cfg.n_heads * cfg.head_dim
            + 2.0 * tokens * cfg.enc_seq * cfg.n_heads * cfg.head_dim * 2.0)
        fwd += cross

    fwd += _logits_flops(cfg, tokens if kind == "train" else float(b))

    if kind == "train":
        mult = 3.0 + (1.0 if cfg.remat == "full" else (0.5 if cfg.remat == "dots" else 0.0))
        flops = fwd * mult
    else:
        flops = fwd

    # ---- bytes (per device) -------------------------------------------------
    n_params = cfg.param_count()
    param_bytes_dev = n_params * pb / chips          # sharded across all chips
    act_bytes_tok = cfg.d_model * 2.0                # bf16 residual stream
    detail: Dict[str, float] = {}
    if kind == "train":
        passes = 3.0 + (1.0 if cfg.remat == "full" else 0.0)
        opt = n_params * (_dtype_bytes(cfg.master_dtype) * 2 +
                          _dtype_bytes(cfg.moment_dtype) * 4) / chips
        acts = (tokens / chips) * act_bytes_tok * len(cfg.layer_kinds()) * 2.0
        hbm = param_bytes_dev * passes + opt + acts
        detail = {"param_rw": param_bytes_dev * passes, "optimizer": opt, "activations": acts}
    elif kind == "prefill":
        acts = (tokens / chips) * act_bytes_tok * len(cfg.layer_kinds())
        cache = _cache_bytes(cfg, b, s) / chips
        hbm = param_bytes_dev + acts + cache
        detail = {"param_r": param_bytes_dev, "activations": acts, "cache_w": cache}
    else:
        cache = _cache_bytes(cfg, b, s) / chips
        hbm = param_bytes_dev + cache + (tokens / chips) * act_bytes_tok * len(cfg.layer_kinds())
        detail = {"param_r": param_bytes_dev, "cache_rw": cache}

    return CostBreakdown(flops=flops, hbm_bytes=hbm, detail=detail)


def _cache_bytes(cfg, b: int, s: int) -> float:
    # bf16: 2 B/elem; int8 KV: 1 B/elem + per-(token, head) bf16 scale
    if getattr(cfg, "kv_cache_dtype", "bfloat16") == "int8":
        elem = 1.0 + 2.0 / max(cfg.head_dim or 1, 1)
    else:
        elem = 2.0
    per_layer_kv = 2.0 * b * s * cfg.n_kv_heads * (cfg.head_dim or 0) * elem
    if cfg.is_encdec:
        cross = 2.0 * b * cfg.enc_seq * cfg.n_kv_heads * cfg.head_dim * 2
        return cfg.n_layers * (per_layer_kv + cross)
    n_attn = sum(1 for m, _ in cfg.layer_kinds() if m == "attn")
    ssm_layers = sum(1 for m, _ in cfg.layer_kinds() if m == "ssm")
    ssmb = (ssm_layers * b * cfg.ssm_nheads * cfg.ssm_headdim *
            cfg.ssm_state * 4.0) if ssm_layers else 0.0
    return per_layer_kv * n_attn + ssmb
