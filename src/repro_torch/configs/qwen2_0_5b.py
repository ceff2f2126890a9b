"""qwen2-0.5b [dense] — GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=True,
    source="arXiv:2407.10671",
))
