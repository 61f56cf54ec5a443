"""Model configuration dataclasses — the port's own copy.

A copy of ``ModelConfig`` and its sub-dataclasses from the JAX
package's ``configs/base.py``, kept field for field so that one config
value means the same model in both packages.  The port imports nothing
of the JAX package, so it keeps this copy instead of importing it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (token-dropping, sort-based dispatch)."""

    num_experts: int
    top_k: int
    ff_dim: int                      # per-expert intermediate size
    num_shared_experts: int = 0      # deepseek-style always-on experts
    capacity_factor: float = 1.25
    first_dense_layers: int = 0      # leading layers that stay dense
    dense_ff_dim: int = 0            # ffn size of those dense layers
    every_k_layers: int = 1          # jamba: MoE on every k-th layer only
    moe_layer_offset: int = 0        # jamba: first MoE layer index
    router_aux_loss: float = 0.001   # load-balance loss weight


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V3)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block (Jamba)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack settings."""

    # position pattern within a repeating unit: "m" = mLSTM, "s" = sLSTM
    pattern: str = "ms"
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    conv1d_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """A single architecture. Field values come from the assignment table."""

    name: str
    family: str                      # dense|moe|vlm|audio|ssm|hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # -- attention variants ------------------------------------------------
    attention: str = "gqa"           # gqa | mla | none (pure ssm)
    qk_norm: bool = False            # qwen3
    attn_softcap: Optional[float] = None    # gemma2: 50.0
    query_pre_attn_scalar: Optional[float] = None  # gemma2-27b: 144
    final_softcap: Optional[float] = None   # gemma2: 30.0
    sliding_window: Optional[int] = None    # gemma2 local layers: 4096
    layer_pattern: Optional[str] = None     # e.g. "LG" local/global repeat
    rope_theta: float = 10000.0
    # positional scheme: "rope" | "sinusoidal" (whisper) | "none" (jamba)
    pos_embed: str = "rope"
    m_rope: bool = False             # qwen2-vl 3-section rope
    m_rope_sections: Tuple[int, int, int] = (16, 24, 24)
    mla: Optional[MLAConfig] = None

    # -- norms / mlp ---------------------------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm_nonparam
    # keep the residual-stream norm bf16-in/bf16-out (stats still fp32)
    norm_bf16_io: bool = False
    act: str = "silu"                # silu (SwiGLU mlp) | gelu (plain mlp)
    post_block_norm: bool = False    # gemma2 post-norms
    tie_embeddings: bool = False
    scale_embeddings: bool = False   # gemma-style sqrt(d) embedding scale

    # -- families beyond dense decoder ---------------------------------------
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (jamba): repeating unit of layer kinds, "M"=mamba, "A"=attention
    hybrid_pattern: Optional[str] = None
    # enc-dec (whisper): decoder uses num_layers; encoder adds these
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    enc_len: int = 1500              # encoder output length (whisper 30 s)
    # deepseek multi-token prediction head (1 extra layer + head)
    mtp: bool = False
    mtp_loss_weight: float = 0.3

    # -- numerics --------------------------------------------------------------
    dtype: str = "bfloat16"          # activation/compute dtype
    param_dtype: str = "float32"     # master weights
    remat: str = "full"              # full | dots | none
    # optimizer: adamw, or adafactor + bf16 params for the ~1T-class archs
    optimizer: str = "adamw"

    # -- implementation knobs ----------------------------------------------------
    # Kept field for field with the JAX package so that configs compare
    # equal across the two.  The port reads ``decode_attn_impl`` (only
    # "auto" and "flash": decode attention always runs the length-aware
    # kernels/decode_attention path), ``prefill_chunk`` (tokens per
    # chunked-prefill admission slice, see serve/engine.py) and
    # ``kv_quant`` (int8 / fp8_e4m3 codes plus float32 row scales in the
    # KV caches, kernels/quant.py); the others steer JAX-only paths (XLA
    # lowering, training) that later slices bring over.
    attn_impl: str = "auto"          # auto | dense | chunked | pallas
    attn_chunk: int = 1024           # q-block for chunked attention
    decode_attn_impl: str = "auto"   # auto | dense | flash
    prefill_chunk: int = 32
    kv_page_size: int = 16
    kv_quant: Optional[str] = None   # None | int8 | fp8_e4m3
    ssm_chunk: int = 128             # time-chunk for mamba scan
    mla_absorb: bool = True          # DeepSeek absorbed-weights decode path
    kernels: str = "reference"       # reference | pallas
    scan_layers: bool = True
    unroll_time_chunks: bool = False
    causal_kv_trim: bool = False
    loss_chunk: int = 2048           # seq-chunk for the xent head (0 = whole)
    max_decode_len: int = 0          # serve: cache size (0 = from shape)

    # -- frontend stubs ---------------------------------------------------------
    # vlm: fraction of the sequence that arrives as precomputed patch embeds
    patch_frac: float = 0.125
    # audio: encoder input is precomputed frame embeddings (B, enc_len, d)

    @property
    def use_rope(self) -> bool:
        return self.pos_embed == "rope"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(1, self.num_kv_heads) != 0:
            raise ValueError(f"{self.name}: num_heads {self.num_heads} not "
                             f"divisible by kv heads {self.num_kv_heads}")
        if self.family == "hybrid" and not self.hybrid_pattern:
            raise ValueError("hybrid family requires hybrid_pattern")
        if self.kv_quant is not None and self.kv_quant not in (
                "int8", "fp8_e4m3"):
            raise ValueError(f"{self.name}: unknown kv_quant "
                             f"{self.kv_quant!r} (int8 | fp8_e4m3)")

    # -- derived sizes --------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        return _param_count(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: shared + top_k experts only)."""
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    if cfg.attention == "mla":
        m = cfg.mla
        qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
        n = d * m.q_lora_rank + m.q_lora_rank * cfg.num_heads * qk_hd
        n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
        n += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim
                                               + m.v_head_dim)
        n += cfg.num_heads * m.v_head_dim * d
        return n
    q = d * cfg.num_heads * hd
    kv = 2 * d * cfg.num_kv_heads * hd
    o = cfg.num_heads * hd * d
    return q + kv + o


def _mlp_params(d: int, ff: int, act: str) -> int:
    return d * ff * (3 if act in ("silu", "geglu") else 2)


def _mamba_params(cfg: ModelConfig) -> int:
    mc = cfg.mamba
    d_in = mc.expand * cfg.d_model
    n = cfg.d_model * 2 * d_in                      # in_proj
    n += d_in * mc.d_conv                            # conv1d
    n += d_in * (mc.dt_rank + 2 * mc.d_state)        # x_proj
    n += mc.dt_rank * d_in + d_in                    # dt_proj
    n += d_in * mc.d_state + d_in                    # A_log, D
    n += d_in * cfg.d_model                          # out_proj
    return n


def _xlstm_params(cfg: ModelConfig, kind: str) -> int:
    xc = cfg.xlstm
    d = cfg.d_model
    if kind == "m":
        d_in = int(xc.mlstm_proj_factor * d)
        n = d * 2 * d_in                 # up proj (x, gate)
        n += 3 * d_in * d_in             # q,k,v
        n += 2 * d_in * 2                # i,f gate projections (per head dim folded)
        n += d_in * d                    # down proj
        return n
    d_in = int(xc.slstm_proj_factor * d)
    n = 4 * d * d                        # i,f,z,o recurrent-input projections
    n += 4 * d * d                       # recurrent weights (block-diag approx)
    n += d * d_in + d_in * d             # ffn up/down
    return n


def mc_conv(xc: XLSTMConfig) -> int:
    return xc.conv1d_kernel


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    d, v = cfg.d_model, cfg.vocab_size
    total = v * d                                    # embedding
    if not cfg.tie_embeddings:
        total += v * d                               # lm head

    def layer_kind(i: int) -> str:
        if cfg.family == "ssm":
            pat = cfg.xlstm.pattern
            return pat[i % len(pat)]
        if cfg.family == "hybrid":
            return cfg.hybrid_pattern[i % len(cfg.hybrid_pattern)]
        return "A"

    def ffn_params(i: int) -> int:
        if cfg.moe is None:
            return _mlp_params(d, cfg.d_ff, cfg.act)
        m = cfg.moe
        if i < m.first_dense_layers or (i % m.every_k_layers) != 0:
            ff = m.dense_ff_dim or cfg.d_ff
            return _mlp_params(d, ff, cfg.act)
        router = d * m.num_experts
        experts = m.num_experts * _mlp_params(d, m.ff_dim, cfg.act)
        shared = m.num_shared_experts * _mlp_params(d, m.ff_dim, cfg.act)
        if active_only:
            experts = m.top_k * _mlp_params(d, m.ff_dim, cfg.act)
        return router + experts + shared

    n_layers = cfg.num_layers
    for i in range(n_layers):
        kind = layer_kind(i)
        if kind in ("A", "a"):
            total += _attn_params(cfg)
            total += ffn_params(i)
        elif kind == "M":
            total += _mamba_params(cfg)
            total += ffn_params(i)
        elif kind in ("m", "s"):
            total += _xlstm_params(cfg, kind)
        # norms are negligible but counted coarsely:
        total += 2 * d
    if cfg.is_encoder_decoder:
        for _ in range(cfg.encoder_layers):
            total += _attn_params(cfg) + _mlp_params(d, cfg.d_ff, cfg.act)
            # cross attention in decoder counted once per decoder layer:
        total += cfg.num_layers * _attn_params(cfg)
    if cfg.mtp:
        total += _attn_params(cfg) + _mlp_params(d, cfg.d_ff or 4 * d, cfg.act)
    return int(total)

