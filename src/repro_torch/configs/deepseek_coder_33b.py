"""deepseek-coder-33b [dense] — llama architecture.

The reference's configuration, value for value ([arXiv:2401.14196]): 62
layers, d_model 7168, 56 heads (GQA kv 8) of 128, d_ff 19,200, vocab
32,256, RoPE theta 1e5.  long_500k is not supported (full attention
only).  Its bf16 weights take ~66.7 GB.
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b",
        arch_type="dense",
        n_layers=62,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=19200,
        vocab_size=32256,
        norm="rmsnorm",
        mlp="swiglu",
        rope_theta=1e5,
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="weighted_grad",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, max_seq_len=256, fl_mode="per_client",
    )
