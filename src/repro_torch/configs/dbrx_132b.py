"""dbrx-132b [moe] — 16 experts top-4, fine-grained.

The reference's configuration, value for value ([hf:databricks/dbrx-base]):
40 layers, d_model 6144, 48 heads (GQA kv 8) of 128, d_ff 10,752 an
expert, vocab 100,352, MoE 16 experts top-4.  long_500k is not supported
(full attention only).  Its bf16 weights take ~263 GB.
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b",
        arch_type="moe",
        n_layers=40,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        head_dim=128,
        d_ff=10752,
        d_ff_expert=10752,
        vocab_size=100352,
        n_experts=16,
        top_k=4,
        norm="rmsnorm",
        mlp="swiglu",
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="weighted_grad",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        d_ff_expert=256,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        max_seq_len=256,
        fl_mode="per_client",
    )
