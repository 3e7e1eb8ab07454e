"""gemma3-1b [dense] — 5:1 local:global sliding-window attention.

The reference's configuration, value for value ([hf:google/gemma-3-1b-pt]):
26 layers, d_model 1152, 4 heads (kv 1, MQA) of 256, d_ff 6912, vocab
262,144, a 512-token window on the local layers and one global layer in
6, qk_norm, tied embeddings.  long_500k is supported: the local layers
attend within their window.
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b",
        arch_type="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        head_dim=256,
        d_ff=6912,
        vocab_size=262144,
        sliding_window=512,
        local_global_ratio=5,
        tie_embeddings=True,
        qk_norm=True,
        norm="rmsnorm",
        mlp="swiglu",
        rope_theta=1e6,
        max_seq_len=524288,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=256, vocab_size=512, sliding_window=32, local_global_ratio=1,
        max_seq_len=256,
    )
