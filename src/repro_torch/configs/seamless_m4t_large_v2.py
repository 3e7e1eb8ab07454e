"""seamless-m4t-large-v2 [audio backbone] — enc-dec, multimodal.

The reference's configuration, value for value ([arXiv:2308.11596]):
24 encoder + 24 decoder layers, d_model 1024, 16 heads (kv 16), head_dim
64, d_ff 8192, vocab 256,206, LayerNorm, GELU.  The speech frontend is a
stub: the encoder takes precomputed frame embeddings (B, frames,
d_model).  long_500k is not supported (pure full-attention enc-dec).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
FRONTEND_FRAMES = 960  # ~30 s of speech at 32 Hz after the conv stack


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        arch_type="audio",
        n_layers=24,
        n_encoder_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        norm="layernorm",
        mlp="gelu",
        frontend_tokens=FRONTEND_FRAMES,
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2,
        n_encoder_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        frontend_tokens=16,
        max_seq_len=256,
    )
