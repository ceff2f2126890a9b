"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2. [arXiv:2402.19427]

26 layers with pattern (RG-LRU, RG-LRU, local-attn) repeating; the final
partial group has 2 RG-LRU layers (26 = 8*3 + 2).
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    sliding_window=2048,          # local attention window
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    tie_embeddings=True,
    source="arXiv:2402.19427",
))
