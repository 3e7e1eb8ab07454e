"""granite-moe-3b-a800m [moe] — many small experts.

The reference's configuration, value for value ([hf:ibm-granite/granite-3.0
family]): 32 layers, d_model 1536, 24 heads (GQA kv 8) of 64, d_ff 512 an
expert, vocab 49,155, MoE 40 experts top-8.  long_500k is not supported
(full attention only).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        head_dim=64,
        d_ff=512,
        d_ff_expert=512,
        vocab_size=49155,
        n_experts=40,
        top_k=8,
        norm="rmsnorm",
        mlp="swiglu",
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=64, d_ff_expert=64, vocab_size=512, n_experts=4, top_k=2,
        max_seq_len=256,
    )
