"""deepseek-v3-671b — DeepSeek-V3 [arXiv:2412.19437].

61L d_model=7168 128H d_ff=2048 vocab=129280, MoE 256e top-8, MLA,
1 shared + 256 routed, MTP.  First 3 layers dense (ff 18432).
The same values as the JAX package's ``configs/deepseek_v3_671b.py``.

The port serves the MLA layers; MoE layers come with a later slice.
``get_config("deepseek-v3-671b", num_layers=3, moe=None, mtp=False)``
is the published model's first three (dense) layers at full width.
"""
import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,                      # leading dense layers' ffn
    vocab_size=129280,
    head_dim=128,
    attention="mla",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=256, top_k=8, ff_dim=2048,
                  num_shared_experts=1, capacity_factor=1.25,
                  first_dense_layers=3, dense_ff_dim=18432),
    mtp=True,
    mtp_loss_weight=0.3,
    param_dtype="bfloat16",
    optimizer="adafactor",
)

REDUCED = dataclasses.replace(
    CONFIG,
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
    vocab_size=256, head_dim=16,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, ff_dim=32, num_shared_experts=1,
                  capacity_factor=1.25, first_dense_layers=1,
                  dense_ff_dim=128),
    loss_chunk=0, attn_chunk=64, ssm_chunk=16,
)
