"""mamba2-370m [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,                  # attention-free
    num_kv_heads=0,
    d_ff=0,                       # mamba2 blocks have no separate MLP
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk_size=256),
    tie_embeddings=True,
    source="arXiv:2405.21060",
))
