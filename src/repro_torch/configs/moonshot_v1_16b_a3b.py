"""moonshot-v1-16b-a3b — Moonlight-16B-A3B.

Pool tags it [dense] but specifies "MoE 64e top-6"; the model card
(hf:moonshotai/Moonlight-16B-A3B) is a DeepSeek-V3-style MoE.  Implemented
as MoE (2 shared + 64 routed top-6) per the spec line; the [dense] tag is
recorded as a pool discrepancy in DESIGN.md.
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,                   # first-layer dense FFN
    vocab_size=163840,
    rope_theta=50000.0,
    moe=MoEConfig(num_experts=64, num_shared_experts=2, top_k=6,
                  d_ff_expert=1408, first_k_dense=1),
    source="hf:moonshotai/Moonlight-16B-A3B",
))
