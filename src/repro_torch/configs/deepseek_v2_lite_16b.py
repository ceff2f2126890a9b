"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512) + fine-grained MoE.

Pool line says both "64e top-6" and "2 shared+160 routed"; 160 routed is
DeepSeek-V2-full.  V2-Lite (the named model, arXiv:2405.04434) is
64 routed + 2 shared, top-6 — we follow the model / the leading "64e".
"""
from repro_torch.configs.base import MLAConfig, MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,                 # qk_nope dim; MLA config governs true dims
    d_ff=10944,                   # dense FFN for the first layer (V2-Lite)
    vocab_size=102400,
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  d_ff_expert=1408, first_k_dense=1),
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=0,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
))
