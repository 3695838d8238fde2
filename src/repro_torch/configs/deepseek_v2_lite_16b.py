"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MoE with MLA (no q-LoRA).

27 layers, d_model=2048, 16 heads, MLA kv_lora=512, 64 routed experts top-6
(expert_ff=1408) + 2 shared, first layer dense (d_ff=10944), vocab 102400.
"""
import dataclasses

from repro_torch.common.config import BlockKind, ModelConfig, MoEConfig

ID = "deepseek-v2-lite-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID,
        num_layers=27,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=10944,                     # dense (first) layer FFN width
        vocab_size=102_400,
        block_pattern=(BlockKind.MLA,),
        kv_lora_rank=512,
        q_lora_rank=0,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
        moe=MoEConfig(
            num_experts=64,
            num_shared_experts=2,
            top_k=6,
            expert_ff=1408,
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
        rope_head_dim=16,
        nope_head_dim=32,
        v_head_dim=32,
        moe=MoEConfig(num_experts=4, num_shared_experts=1, top_k=2,
                      expert_ff=64, first_dense_layers=1),
    )
