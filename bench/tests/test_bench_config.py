"""The serving configuration file against the catalog's AI21-Jamba2-Mini
entry, and every number of it reaching the port's ``ModelConfig``."""
import json

import pytest

from bench import manifest as mf
from bench.env import ROOT

# the catalog's ``config`` of AI21-Jamba2-Mini (model-configs catalog,
# source https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/config.json)
CATALOG = {
    "attn_layer_offset": 4, "attn_layer_period": 8, "expert_layer_offset": 1,
    "expert_layer_period": 2, "hidden_act": "silu", "hidden_size": 4096,
    "intermediate_size": 14336, "mamba_conv_bias": True, "mamba_d_conv": 4,
    "mamba_d_state": 16, "mamba_dt_rank": 256, "mamba_expand": 2,
    "mamba_proj_bias": False, "max_position_embeddings": 262144,
    "model_type": "jamba", "num_attention_heads": 32, "num_experts": 16,
    "num_experts_per_tok": 2, "num_hidden_layers": 32,
    "num_key_value_heads": 8, "num_logits_to_keep": 1, "rms_norm_eps": 1e-06,
    "sliding_window": None, "tie_word_embeddings": False,
    "use_mamba_kernels": True, "vocab_size": 65536}
# keys whose value no width depends on and the cut may change
WIDTHS = ("hidden_size", "intermediate_size", "mamba_d_conv",
          "mamba_d_state", "mamba_dt_rank", "mamba_expand",
          "num_attention_heads", "num_key_value_heads", "num_experts_per_tok")

MAN = mf.manifest()
ENTRY = mf.config_entry(MAN, "jamba2-mini-rag")
FILE = json.loads((ROOT / ENTRY["file"]).read_text())


def test_source_is_the_catalogs():
    assert ENTRY["source"] == FILE["source"] == (
        "https://huggingface.co/ai21labs/AI21-Jamba2-Mini/blob/main/"
        "config.json")


@pytest.mark.parametrize("key", sorted(CATALOG))
def test_catalog_key_kept_or_listed(key):
    assert key in FILE
    if FILE[key] != CATALOG[key]:
        assert key in ENTRY["reduced"] and key in FILE["reduced"]
        assert key not in WIDTHS


def test_reduced_is_exactly_what_changed():
    changed = {k for k in CATALOG if FILE[k] != CATALOG[k]}
    assert changed == set(ENTRY["reduced"]) == set(FILE["reduced"])
    for k, v in FILE["reduced"].items():
        assert v["published"] == CATALOG[k] and v["here"] == FILE[k]


def test_every_number_reaches_the_model_config():
    from bench.systems.serve import model_config
    from repro_torch.models import mamba, transformer

    cfg = model_config(FILE)
    a = FILE["assumed"]
    assert cfg.num_layers == FILE["num_hidden_layers"]
    assert cfg.d_model == FILE["hidden_size"]
    assert cfg.num_heads == FILE["num_attention_heads"]
    assert cfg.num_kv_heads == FILE["num_key_value_heads"]
    assert cfg.d_ff == cfg.moe.expert_ffn == FILE["intermediate_size"]
    assert cfg.vocab_size == FILE["vocab_size"]
    assert transformer.lm_head_vocab(cfg) == FILE["vocab_size"]
    assert cfg.resolved_head_dim == a["head_dim"]
    assert cfg.moe.num_experts == FILE["num_experts"]
    assert cfg.moe.top_k == FILE["num_experts_per_tok"]
    assert cfg.moe.capacity_factor == a["capacity_factor"]
    assert cfg.moe_every == FILE["expert_layer_period"]
    assert cfg.attn_every == FILE["attn_layer_period"]
    assert cfg.mamba_d_state == FILE["mamba_d_state"]
    assert cfg.mamba_d_conv == FILE["mamba_d_conv"]
    assert cfg.mamba_expand == FILE["mamba_expand"]
    assert mamba.dt_rank_for(cfg.d_model) == FILE["mamba_dt_rank"]
    assert cfg.norm_eps == FILE["rms_norm_eps"]
    assert cfg.tie_embeddings is FILE["tie_word_embeddings"]
    assert cfg.max_seq_len == FILE["max_position_embeddings"]
    assert cfg.rope_theta == a["rope_theta"] and cfg.dtype == a["torch_dtype"]
    kinds = transformer.group_layer_kinds(cfg)
    assert kinds.index("attn") == FILE["attn_layer_offset"]
    assert kinds.count("mamba") == 7
    moe_at = [i for i in range(cfg.attn_every) if transformer._uses_moe(cfg, i)]
    assert moe_at == list(range(FILE["expert_layer_offset"],
                                cfg.attn_every, FILE["expert_layer_period"]))


@pytest.mark.parametrize("key,value", [("attn_layer_offset", 3),
                                       ("expert_layer_offset", 1),
                                       ("mamba_dt_rank", 128),
                                       ("sliding_window", 4096)])
def test_a_key_the_port_cannot_honour_raises(key, value):
    from bench.systems.serve import model_config

    with pytest.raises(ValueError, match=key):
        model_config(dict(FILE, **{key: value}))


def test_pool_config_holds_the_ports_defaults():
    from repro_torch.configs.base import VectorPoolConfig

    pool = json.loads((ROOT / mf.config_entry(MAN, "sift1m-pool")["file"])
                      .read_text())
    default = VectorPoolConfig()
    for k, v in pool["pool"].items():
        assert getattr(default, k) == v, k
    assert pool["num_vectors"] == 1_000_000 and pool["dim"] == 128
