"""deepseek-v3-671b [moe] — MLA attention, 1 shared + 256 routed top-8
experts. [arXiv:2412.19437; hf]

Copied from ``repro.configs.deepseek_v3_671b``. The MTP (multi-token
prediction) head is not modeled. The assigned d_ff=2048 is the per-expert
hidden dim; the first 3 layers use a dense FFN of 18432 per the released
config.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="lm",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,            # v head dim
    d_ff=2048,             # per-expert hidden (assigned)
    vocab_size=129280,
    act="silu",
    mlp_kind="glu",
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_dim=128,
    ),
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  capacity_factor=1.25),
    moe_every=1,
    first_k_dense=3,
    dense_d_ff=18432,
    rope_theta=1e4,
)
