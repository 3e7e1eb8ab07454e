"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE.

The reference's configuration, value for value ([arXiv:2403.19887]): 72
layers, d_model 8192, 64 heads (GQA kv 8) of 128, d_ff 24576, vocab
65,536, MoE 16 experts top-2; one attention layer per 8 (9 periods of
[attn, 7x mamba]), a MoE MLP every other layer; Mamba d_inner 16,384 as
256 SSM heads of 64, d_state 16, conv 4, chunk 64.

``replace(moe_every=0)`` gives every layer the config's dense SwiGLU
MLP.  One period with its experts holds ~45 B params (~90 GB in bf16);
``full().replace(n_layers=8, n_experts=4)`` holds ~16 B.
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        d_ff_expert=24576,
        vocab_size=65536,
        n_experts=16,
        top_k=2,
        attn_every=8,
        moe_every=2,
        ssm_d_state=16,
        ssm_expand=2,
        ssm_chunk=64,
        norm="rmsnorm",
        mlp="swiglu",
        max_seq_len=524288,
        dtype=dtype,
        fl_mode="weighted_grad",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=4,
        attn_every=4,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        d_ff_expert=256,
        vocab_size=512,
        n_experts=4,
        top_k=2,
        ssm_chunk=16,
        max_seq_len=256,
        fl_mode="per_client",
    )
