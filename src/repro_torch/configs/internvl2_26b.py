"""internvl2-26b [vlm] — InternViT frontend (stubbed) + InternLM2 backbone.

The ViT frontend is a STUB per the assignment: ``input_specs`` provides
precomputed patch embeddings (frontend_dim=3200, InternViT-6B width); the
model owns only the projector + language backbone. [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    rope_theta=1000000.0,
    modality="vision",
    frontend_dim=3200,
    num_prefix_tokens=256,        # 256 image patches per sample
    source="arXiv:2404.16821",
))
