"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained. [arXiv:2401.06066]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                   # first-layer dense FFN
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  d_ff_expert=1408, first_k_dense=1),
    source="arXiv:2401.06066",
))
