"""llama3-8b — the paper's own HyperOffload evaluation model (Llama-8B,
5.2s -> 4.08s per step).  Not part of the assigned pool; used by the
paper-claim benchmarks."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama3-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    source="paper §3.2 (HyperOffload training claim)",
))
