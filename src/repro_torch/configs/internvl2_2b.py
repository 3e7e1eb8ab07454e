"""internvl2-2b [vlm] — InternViT + InternLM2 backbone.

The reference's configuration, value for value ([arXiv:2404.16821]): 24
layers, d_model 2048, 16 heads (GQA kv 8) of 128, d_ff 8192, vocab
92,553.  The InternViT-300M vision tower is a stub: the model takes
(B, patches, d_model) patch embeddings, which its projector ``proj`` and
the LM consume.  long_500k is not supported (full attention only).
"""

from repro_torch.models.common import ModelConfig

SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
VISION_PATCHES = 1024  # 4 tiles x 256 patches after pixel-shuffle


def full(dtype: str = "bfloat16") -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        arch_type="vlm",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92553,
        norm="rmsnorm",
        mlp="swiglu",
        frontend_tokens=VISION_PATCHES,
        max_seq_len=32768,
        dtype=dtype,
        fl_mode="per_client",
    )


def smoke() -> ModelConfig:
    return full(dtype="float32").replace(
        n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, frontend_tokens=16, max_seq_len=256,
    )
