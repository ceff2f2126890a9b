"""musicgen-large [audio] — decoder-only over EnCodec tokens.

The EnCodec/conditioning frontend is a STUB per the assignment:
``input_specs`` provides precomputed conditioning-frame embeddings; the
model owns the token decoder (vocab = 2048 EnCodec codebook entries).
[arXiv:2306.05284]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,              # MHA
    d_ff=8192,
    vocab_size=2048,
    rope_theta=10000.0,
    modality="audio",
    frontend_dim=1024,            # T5-style conditioning embedding width
    num_prefix_tokens=64,         # conditioning frames per sample
    source="arXiv:2306.05284",
))
