"""DeepSeek-V2 236B [arXiv:2405.04434] — MoE with Multi-head Latent Attention.

60 layers, d_model=5120, 128 heads, MLA kv_lora=512 q_lora=1536
(rope_head 64, nope_head 128, v_head 128), 160 routed experts top-6 +
2 shared experts (expert_ff=1536), first layer dense, vocab 102400.
"""
import dataclasses

from repro_torch.common.config import BlockKind, ModelConfig, MoEConfig

ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,
        d_ff=12288,                     # dense (first) layer FFN width
        vocab_size=102_400,
        block_pattern=(BlockKind.MLA,),
        kv_lora_rank=512,
        q_lora_rank=1536,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        moe=MoEConfig(
            num_experts=160,
            num_shared_experts=2,
            top_k=6,
            expert_ff=1536,
            first_dense_layers=1,
        ),
    )


def reduced() -> ModelConfig:
    return dataclasses.replace(
        config(),
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        kv_lora_rank=64,
        q_lora_rank=96,
        rope_head_dim=16,
        nope_head_dim=32,
        v_head_dim=32,
        moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2,
                      expert_ff=64, first_dense_layers=1),
    )
