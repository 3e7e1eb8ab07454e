"""qwen3-0.6b [dense] — qk_norm, GQA.

The reference's configuration, value for value ([hf:Qwen/Qwen3-8B
family]): 28 layers, d_model 1024, 16 heads (GQA kv 8), head_dim 128
(decoupled from d_model / n_heads), d_ff 3072, vocab 151,936, tied
embeddings, RoPE theta 1e6.  long_500k is not supported (full attention
only).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="qwen3-0.6b",
        arch_type="dense",
        n_layers=28,
        d_model=1024,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=3072,
        vocab_size=151936,
        qk_norm=True,
        tie_embeddings=True,
        norm="rmsnorm",
        mlp="swiglu",
        rope_theta=1e6,
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, max_seq_len=256,
    )
