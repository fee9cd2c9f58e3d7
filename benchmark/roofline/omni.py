"""The audio language model's arithmetic (Uni-MoE-2.0-Omni's speech-to-text
path): the model's FLOPs for a batch, and the bytes and operations one
decode step's MoE layer needs, from the configuration's published sizes
(``llm``: the configuration file's keys) and the routing the program's
counter recorded. Multiply-accumulates count 2; weights are bfloat16 (2
bytes), the router float32."""

from __future__ import annotations

from typing import Dict

from benchmark.roofline import flops


def _expert(llm: Dict, ffn: int) -> float:
    """One SwiGLU expert's multiply-accumulates a token: gate, up, down."""
    return 3.0 * llm["hidden_size"] * ffn


def _dense_token_layer(llm: Dict) -> float:
    """One token through one layer outside the routed experts and the
    attention scores: q, k, v, o, the router, the shared experts; FLOPs."""
    D, H, Hkv = llm["hidden_size"], llm["num_attention_heads"], llm["num_key_value_heads"]
    Dh = D // H
    slots = llm["mlp_dynamic_expert_num"] + llm["mlp_dynamic_null_expert_num"]
    macs = D * H * Dh * 2 + 2 * D * Hkv * Dh + D * slots
    macs += llm["mlp_fixed_expert_num"] * _expert(llm, llm["shared_intermediate_size"])
    return 2.0 * macs


def batch_flops(llm: Dict, dims: Dict[str, int], batch: int, n_prompt: int,
                sample_len: int, routed_picks: float) -> float:
    """A batch's model FLOPs: the tower (``flops.encoder_flops``), the
    connector's product, the prefill of every prompt position, the decode
    steps (``sample_len`` - 1 forwards a row, each attending over the
    positions before it and itself), the head on the prompt's last
    position and each decode step, and ``routed_picks`` routed-expert
    passes (the non-null picks the routing made over the batch, every
    layer, prefill and decode)."""
    D, L, V = llm["hidden_size"], llm["num_hidden_layers"], llm["vocab_size"]
    H = llm["num_attention_heads"]
    Dh = D // H
    tower = flops.encoder_flops(dims["n_mels"], dims["d_model"], dims["encoder_layers"],
                                dims["n_audio_ctx"])
    conn = 2.0 * llm["whisper_query_tokens_size"] * llm["whisper_hidden_size"] * D
    steps = sample_len - 1
    positions = n_prompt + steps
    dense = _dense_token_layer(llm) * L * positions
    # q k^T and p v over the causal window: 4 H Dh a (query, key) pair
    pairs = n_prompt * (n_prompt + 1) / 2.0 + sum(n_prompt + s + 1 for s in range(steps))
    attn = 4.0 * H * Dh * pairs * L
    head = 2.0 * D * V * (1 + steps)
    per_row = tower + conn + dense + attn + head
    routed = 2.0 * _expert(llm, llm["dynamic_intermediate_size"]) * routed_picks
    return batch * per_row + routed


def moe_decode_layer(llm: Dict, rows: int, experts_needed: int, picks: float):
    """One decode step's MoE in one layer over ``rows`` rows: (bytes,
    FLOPs) of what the routing needs: the weights of the
    ``experts_needed`` routed experts it chose, of the shared experts and
    of the router, each read once, the rows' input read and output
    written once (bf16); the products of every row with the shared
    experts and the router, and of ``picks`` (row, routed expert) pairs."""
    D = llm["hidden_size"]
    F, Fs = llm["dynamic_intermediate_size"], llm["shared_intermediate_size"]
    S = llm["mlp_fixed_expert_num"]
    slots = llm["mlp_dynamic_expert_num"] + llm["mlp_dynamic_null_expert_num"]
    weights = 2 * 3 * D * (experts_needed * F + S * Fs) + 4 * D * slots
    io = 2 * 2 * rows * D
    macs = rows * (_expert(llm, Fs) * S + D * slots) + picks * _expert(llm, F)
    return float(weights + io), 2.0 * macs
