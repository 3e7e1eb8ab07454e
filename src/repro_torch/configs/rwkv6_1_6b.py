"""rwkv6-1.6b [ssm] — "Finch", data-dependent per-channel decay.

The reference's configuration, value for value ([arXiv:2404.05892]): 24
layers, d_model 2048 (attention-free), d_ff 7168, vocab 65,536; 32 heads
of 64 for the wkv state, chunks of 32.  long_500k is supported: the
decode state is O(1) in the sequence (a (H, 64, 64) wkv state and the
token-shift vectors a layer).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=32,  # wkv heads of dim 64
        n_kv_heads=32,
        d_ff=7168,
        vocab_size=65536,
        norm="layernorm",
        ssm_chunk=32,
        max_seq_len=524288,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=2, n_kv_heads=2, d_ff=256,
        vocab_size=512, ssm_chunk=16, max_seq_len=256,
    )
