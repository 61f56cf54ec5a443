"""smollm-135m — HuggingFaceTB/SmolLM-135M (llama-arch small).

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152, tied embeddings.
The same values as the JAX package's ``configs/smollm_135m.py``.
"""
import dataclasses

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
)

REDUCED = dataclasses.replace(
    CONFIG,
    num_layers=2, d_model=48, num_heads=3, num_kv_heads=1, d_ff=128,
    vocab_size=256,
    loss_chunk=0, attn_chunk=64,
)
