"""olmo-1b [dense] — non-parametric LayerNorm.

The reference's configuration, value for value ([arXiv:2402.00838]): 16
layers, d_model 2048, 16 heads (kv 16) of 128, d_ff 8192, vocab 50,304,
LayerNorm without affine params, SwiGLU.  long_500k is not supported
(full attention only).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=8192,
        vocab_size=50304,
        norm="nonparametric_ln",
        mlp="swiglu",
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, max_seq_len=256,
    )
